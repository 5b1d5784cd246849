"""utils: profiling roofline model + checkpoint round-trips."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import sputnik_tpu as st
from sputnik_tpu.models import SparseLinear
from sputnik_tpu.ops import panel_api as P


def test_roofline_sane():
    from sputnik_tpu.utils.profiling import roofline

    rng = np.random.RandomState(0)
    A = ((rng.rand(256, 256) < 0.2) * rng.randn(256, 256)).astype(np.float32)
    spec = P.PanelSpec(st.SparseMatrix(A).topology)
    r = roofline(spec, 256, device_kind="NVIDIA H100 80GB HBM3")
    assert r["speed_of_light_ms"] > 0
    assert 0 < r["block_occupancy"] <= 1
    assert 0 < r["useful_flop_fraction"] <= 1
    assert r["flops"] >= 2 * st.SparseMatrix(A).topology.nnz * 256
    # a device without published peaks is an error, not a default
    with pytest.raises(ValueError):
        roofline(spec, 256, device_kind="cpu")


def test_measure_runs_on_cpu():
    from sputnik_tpu.utils.profiling import measure

    f = jax.jit(lambda x: x * 2.0)
    ms = measure(f, jnp.ones((128, 128)), iters=4, repeats=1)
    assert ms >= 0


def test_csr_export_import_roundtrip():
    from sputnik_tpu.utils.checkpoint import export_csr, import_csr

    rng = np.random.RandomState(1)
    w = ((rng.rand(48, 64) < 0.3) * rng.randn(48, 64)).astype(np.float32)
    layer = SparseLinear.from_mask(w != 0)
    vp = layer.pack_dense(w)
    blob = export_csr(layer, vp)
    back = import_csr(layer, blob)
    np.testing.assert_allclose(back, vp)
    # portable across layouts: reload into a csr-layout layer
    layer_csr = SparseLinear(topology=layer.topology, layout="csr")
    flat = import_csr(layer_csr, blob)
    np.testing.assert_allclose(layer_csr.unpack_dense(flat), w)


def test_orbax_checkpoint_roundtrip(tmp_path):
    from sputnik_tpu.utils.checkpoint import (
        restore_checkpoint,
        save_checkpoint,
    )

    rng = np.random.RandomState(2)
    w = ((rng.rand(32, 32) < 0.4) * rng.randn(32, 32)).astype(np.float32)
    layer = SparseLinear.from_mask(w != 0)
    x = jnp.asarray(rng.randn(4, 32).astype(np.float32))
    params = layer.init(jax.random.PRNGKey(0), x)
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, params)
    restored = restore_checkpoint(path, params)
    got = layer.apply(restored, x)
    want = layer.apply(params, x)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want))


def test_orbax_restore_sharded(tmp_path):
    """Restore a host-saved checkpoint directly into a mesh-sharded
    layout (the multi-chip resume path): pass `like` leaves carrying
    NamedShardings and orbax places each shard on its device."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from sputnik_tpu.utils.checkpoint import (
        restore_checkpoint,
        save_checkpoint,
    )

    rng = np.random.RandomState(3)
    tree = {"w": rng.randn(16, 32).astype(np.float32),
            "b": rng.randn(32).astype(np.float32)}
    path = str(tmp_path / "ckpt_sharded")
    save_checkpoint(path, tree)

    mesh = Mesh(np.array(jax.devices()[:8]), ("dp",))
    like = {
        "w": jax.ShapeDtypeStruct(
            (16, 32), np.float32,
            sharding=NamedSharding(mesh, P("dp", None))),
        "b": jax.ShapeDtypeStruct(
            (32,), np.float32, sharding=NamedSharding(mesh, P())),
    }
    restored = restore_checkpoint(path, like)
    assert restored["w"].sharding == like["w"].sharding
    np.testing.assert_allclose(np.asarray(restored["w"]), tree["w"])
    np.testing.assert_allclose(np.asarray(restored["b"]), tree["b"])


def test_csr_export_import_preserves_dtype():
    """bf16 serving params must round-trip bf16 (forcing f32 doubled
    decode weight traffic and changed the jit signature on restore)."""
    import jax.numpy as jnp

    from sputnik_tpu.models.linear import SparseLinear
    from sputnik_tpu.utils.checkpoint import export_csr, import_csr

    rng = np.random.RandomState(11)
    W = ((rng.rand(32, 48) < 0.4) * rng.randn(32, 48)).astype(np.float32)
    layer = SparseLinear.from_mask(W != 0)
    vals16 = jnp.asarray(layer.pack_dense(W), jnp.bfloat16)
    blob = export_csr(layer, vals16)
    assert np.asarray(blob["values"]).dtype == np.asarray(vals16).dtype
    back = import_csr(layer, blob)
    assert back.dtype == np.asarray(vals16).dtype
    np.testing.assert_array_equal(np.asarray(back),
                                  np.asarray(vals16))


def test_stacked_panel_preserves_dtype():
    import jax.numpy as jnp
    import sputnik_tpu as st
    from sputnik_tpu.parallel import RowPartition

    rng = np.random.RandomState(12)
    A = ((rng.rand(64, 64) < 0.3) * rng.randn(64, 64)).astype(np.float32)
    mat = st.SparseMatrix(A)
    part = RowPartition(mat.topology, 2, bm=16)
    vals16 = np.asarray(jnp.asarray(mat.values, jnp.bfloat16))
    panels = part.stacked_panel(vals16, 16, 16)
    assert panels.dtype == vals16.dtype


def test_moe_checkpoint_csr_roundtrip():
    """MoE expert-bank values export to tiling-independent flat CSR and
    import back bit-identically, dtype preserved (bf16 serving weights)."""
    import jax

    from sputnik_tpu.models.moe import SparseMoE
    from sputnik_tpu.patterns import block_random_topology
    from sputnik_tpu.utils.checkpoint import export_moe_csr, import_moe_csr

    rng = np.random.RandomState(0)
    h, f, E = 64, 128, 3
    ti = block_random_topology(f, h, 16, 64, density=0.5, seed=0)
    to = block_random_topology(h, f, 16, 64, density=0.5, seed=1)
    moe = SparseMoE(topo_in=ti, topo_out=to, num_experts=E)
    x = jnp.asarray(rng.randn(2, 8, h).astype(np.float32))
    params = moe.init(jax.random.PRNGKey(0), x)["params"]

    # bf16 serving weights must stay bf16 through the round trip
    p16 = dict(params,
               w_in_values=jnp.asarray(params["w_in_values"],
                                       jnp.bfloat16),
               w_out_values=jnp.asarray(params["w_out_values"],
                                        jnp.bfloat16))
    blob = export_moe_csr(moe, p16)
    assert blob["w_in"]["values"].shape == (E, ti.nnz)
    assert blob["w_in"]["values"].dtype == jnp.bfloat16
    back = import_moe_csr(moe, blob)
    np.testing.assert_array_equal(np.asarray(back["w_in_values"]),
                                  np.asarray(p16["w_in_values"]))
    np.testing.assert_array_equal(np.asarray(back["w_out_values"]),
                                  np.asarray(p16["w_out_values"]))

    # wrong expert count / topology rejected
    moe2 = SparseMoE(topo_in=ti, topo_out=to, num_experts=E + 1)
    with pytest.raises(ValueError):
        import_moe_csr(moe2, blob)


def test_elastic_recovers_from_mid_run_failure(tmp_path):
    """run_elastic: a step that blows up mid-run rolls back to the last
    checkpoint and the loop completes with the same result as a clean
    run; restart budget and failure accounting enforced."""
    from sputnik_tpu.utils.elastic import (device_healthy, run_elastic)

    assert device_healthy(timeout_s=60.0)  # CPU backend: trivially alive

    calls = {"n": 0}

    def step(state, t):
        calls["n"] += 1
        if t == 7 and calls["n"] == 8:      # fail ONCE at step 7
            raise RuntimeError("injected device loss")
        return {"w": state["w"] + jnp.ones_like(state["w"]) * (t + 1)}

    s0 = {"w": jnp.zeros((4,), jnp.float32)}
    res = run_elastic(step, s0, 10, checkpoint_every=5,
                      checkpoint_dir=str(tmp_path / "a"), max_restarts=2)
    assert res.step == 10 and res.restarts == 1
    assert len(res.failures) == 1 and "injected" in res.failures[0][1]
    # clean-run equivalence: sum of 1..10
    np.testing.assert_allclose(np.asarray(res.state["w"]),
                               np.full(4, 55.0))

    # exhausted budget re-raises
    def always_fail(state, t):
        if t == 2:
            raise RuntimeError("hard down")
        return state

    with pytest.raises(RuntimeError):
        run_elastic(always_fail, s0, 5, checkpoint_every=2,
                    checkpoint_dir=str(tmp_path / "b"), max_restarts=1)

"""Route selection, the compile-cache helper, the card-only entry points,
and the flax-free model layer."""

import os
import shutil
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import sputnik_tpu as st
from sputnik_tpu.ops import _common

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- route selection ----------------------------------------------------------


def test_cpu_route_is_plain():
    assert jax.default_backend() == "cpu"
    assert _common.route() == "plain"


def test_interpret_switch_and_xla_override():
    with _common.interpret_kernels():
        assert _common.route() == "interpret"
        st.set_backend("xla")
        try:
            assert _common.route() == "plain"     # "xla" forces plain
        finally:
            st.set_backend("auto")
        with _common.interpret_kernels():         # nests, restores
            assert _common.route() == "interpret"
        assert _common.route() == "interpret"
    assert _common.route() == "plain"


def test_gpu_route_is_kernel(monkeypatch):
    monkeypatch.setattr(_common, "on_gpu", lambda: True)
    assert _common.route() == "kernel"
    st.set_backend("xla")
    try:
        assert _common.route() == "plain"
    finally:
        st.set_backend("auto")


def test_pallas_backend_needs_a_gpu():
    with pytest.raises(ValueError, match="GPU"):
        st.set_backend("pallas")
    assert st.ops.get_backend() == "auto"


def test_unknown_backend_rejected():
    with pytest.raises(ValueError):
        st.set_backend("triton")


@pytest.mark.parametrize("route", ["plain", "interpret"])
def test_panel_route_reaches_its_body(route, monkeypatch):
    """The plain route never builds a pallas_call; the kernel route does."""
    from sputnik_tpu.ops import panel_api as P

    topo = st.SparseTopology.from_dense_mask(
        (np.random.RandomState(0).rand(32, 32) < 0.5).astype(np.float32))
    spec = P.PanelSpec(topo, bm=16, bk=16)
    panel = jnp.zeros(spec.view.values_shape, jnp.float32)
    dense = jnp.zeros((32, 16), jnp.float32)

    def text():
        return str(jax.make_jaxpr(lambda p, d: P.spmm(spec, p, d))(
            panel, dense))

    if route == "interpret":
        with _common.interpret_kernels():
            assert "pallas_call" in text()
    else:
        assert "pallas_call" not in text()


# -- compile cache ------------------------------------------------------------


def test_compile_cache_env_wins(monkeypatch, tmp_path):
    from sputnik_tpu.utils import compile_cache as cc

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(cc.ENV, str(tmp_path))
    assert cc.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before   # set nothing


def test_compile_cache_default_in_checkout(monkeypatch):
    from sputnik_tpu.utils import compile_cache as cc

    monkeypatch.delenv(cc.ENV, raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = cc.enable_compile_cache()
        assert path == os.path.join(ROOT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


# -- card-only entry points fail without a card -------------------------------


def _run_cpu(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_gpu_scripts_fail_on_cpu(script):
    out = _run_cpu([os.path.join(ROOT, script)], ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"value"' not in out.stdout
    assert "needs a GPU" in out.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = _run_cpu(["chip_smoke.py"], str(tmp_path))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_device_helpers_on_cpu():
    from sputnik_tpu.utils.device import device_record, require_gpu
    from sputnik_tpu.utils.profiling import chip_peaks

    with pytest.raises(SystemExit):
        require_gpu()
    rec = device_record()
    assert rec["platform"] == "cpu" and rec["count"] == len(jax.devices())
    assert chip_peaks("NVIDIA H100 80GB HBM3") == (3350.0, 989.0, 495.0)
    with pytest.raises(ValueError):
        chip_peaks()            # the CPU has no published peaks


# -- the model layer without flax ---------------------------------------------

_NO_FLAX = r"""
import sys
sys.modules["flax"] = None
sys.modules["flax.linen"] = None
import numpy as np, jax, jax.numpy as jnp
import sputnik_tpu.models as M
masks = np.broadcast_to(np.tril(np.ones((16, 16), np.float32)), (2, 16, 16))
lm = M.SparseLM.from_masks(masks.copy(), vocab_size=11, num_layers=1,
                           hidden_size=16, num_heads=2, ffn_hidden_size=32,
                           use_layernorm=True, use_residual=True)
toks = jnp.zeros((2, 16), jnp.int32)
p = lm.init(jax.random.PRNGKey(0), toks)
assert lm.apply(p, toks).shape == (2, 16, 11)
lin = M.SparseLinear.from_mask(np.ones((8, 4), np.float32))
assert lin.apply(lin.init(jax.random.PRNGKey(1), jnp.ones((3, 4))),
                 jnp.ones((3, 4))).shape == (3, 8)
print(sorted(p["params"]), sorted(p["params"]["core"]["layer_0"]))
"""


def test_models_import_and_run_without_flax():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", _NO_FLAX], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "['core', 'embed', 'ln_f']" in out.stdout
    assert "'ln_attn', 'ln_mlp', 'mlp', 'self_attention'" in out.stdout


def _tiny_lm(**kw):
    from sputnik_tpu.models import SparseLM

    masks = np.broadcast_to(np.tril(np.ones((16, 16), np.float32)),
                            (2, 16, 16)).copy()
    cfg = dict(vocab_size=13, num_layers=2, hidden_size=32, num_heads=2,
               ffn_hidden_size=64, use_layernorm=True, use_residual=True)
    cfg.update(kw)
    return SparseLM.from_masks(masks, **cfg)


def test_parameter_tree_names_and_shapes():
    lm = _tiny_lm(tie_embeddings=False)
    p = lm.init(jax.random.PRNGKey(0), jnp.zeros((2, 16), jnp.int32))
    shapes = jax.tree.map(lambda x: x.shape, p["params"])
    assert shapes["embed"] == {"embedding": (13, 32)}
    assert shapes["ln_f"] == {"scale": (32,), "bias": (32,)}
    assert shapes["lm_head"] == {"kernel": (32, 13)}
    layer = shapes["core"]["layer_1"]
    assert layer["self_attention"] == {
        "query_key_value": {"kernel": (32, 96), "bias": (96,)},
        "dense": {"kernel": (32, 32), "bias": (32,)}}
    assert layer["mlp"] == {"to_4h": {"kernel": (32, 64), "bias": (64,)},
                            "to_h": {"kernel": (64, 32), "bias": (32,)}}
    assert layer["ln_attn"] == layer["ln_mlp"] == {"scale": (32,),
                                                   "bias": (32,)}


def test_default_initialisers():
    """LeCun-normal kernels, zero biases, unit LayerNorm scales,
    1/sqrt(features) embeddings — and the tree is a function of the key."""
    lm = _tiny_lm(hidden_size=256, ffn_hidden_size=512, num_layers=1)
    toks = jnp.zeros((2, 16), jnp.int32)
    p = lm.init(jax.random.PRNGKey(0), toks)["params"]
    k = np.asarray(p["core"]["layer_0"]["mlp"]["to_4h"]["kernel"])
    assert abs(k.std() * np.sqrt(256) - 1.0) < 0.05
    assert np.abs(k).max() <= 2.0 / np.sqrt(256) / 0.8796 + 1e-6
    assert not np.asarray(p["core"]["layer_0"]["mlp"]["to_4h"]["bias"]).any()
    assert (np.asarray(p["ln_f"]["scale"]) == 1).all()
    e = np.asarray(p["embed"]["embedding"])
    assert abs(e.std() * np.sqrt(256) - 1.0) < 0.1
    p2 = lm.init(jax.random.PRNGKey(0), toks)["params"]
    assert all(np.array_equal(a, b) for a, b in
               zip(jax.tree.leaves(p), jax.tree.leaves(p2)))


def test_apply_missing_parameter_raises():
    lm = _tiny_lm()
    toks = jnp.zeros((2, 16), jnp.int32)
    p = lm.init(jax.random.PRNGKey(0), toks)
    del p["params"]["ln_f"]
    with pytest.raises(KeyError):
        lm.apply(p, toks)


def test_remat_collects_moe_intermediates():
    """Sown values cross the jax.checkpoint boundary: every MoE layer's
    aux loss comes back from a rematerialised transformer."""
    from sputnik_tpu.models import SparseMoE, SparseTransformer
    from sputnik_tpu.patterns import block_random_topology

    h, f = 32, 64
    moe = SparseMoE(topo_in=block_random_topology(f, h, 16, 16, density=0.5,
                                                  seed=0),
                    topo_out=block_random_topology(h, f, 16, 16,
                                                   density=0.5, seed=1),
                    num_experts=2)
    masks = np.broadcast_to(np.tril(np.ones((16, 16), np.float32)),
                            (2, 16, 16)).copy()
    x = jnp.asarray(np.random.RandomState(0).randn(2, 16, h), jnp.float32)
    outs = []
    for remat in (False, True):
        model = SparseTransformer.from_masks(
            masks, num_layers=2, hidden_size=h, num_heads=2,
            ffn_hidden_size=f, use_residual=True, moe=moe, moe_every=1,
            remat=remat)
        p = model.init(jax.random.PRNGKey(0), x)
        y, inter = model.apply(p, x, mutable=["intermediates"])
        aux = [v for v in jax.tree.leaves(inter)]
        assert len(aux) == 2 and all(np.isfinite(float(a)) for a in aux)
        outs.append(np.asarray(y))
    np.testing.assert_allclose(outs[0], outs[1], atol=1e-5)

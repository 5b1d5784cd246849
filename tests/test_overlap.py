"""Comm/compute overlap: dataflow evidence + parity of the split paths.

The BASELINE north star demands halo/band exchanges "overlapped with
kernel compute". Overlap is a SCHEDULING property, but it has a necessary
dataflow precondition the compiler cannot invent: within one step, the
collective must not consume kernel outputs, and (for the halo split) at
least one kernel pass must not consume collective outputs. These tests
assert that precondition on the traced jaxpr of the real code paths —
if a refactor re-serializes the transfer behind the kernel (or the
interior kernel behind the transfer), they fail.

Taint analysis: walk every (sub)jaxpr with positional taint propagation
through call-like primitives (shard_map/pjit/custom_vjp carry invar
taints across the boundary; scan bodies are analyzed step-locally, i.e.
carry enters untainted — exactly the per-step overlap question).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh, PartitionSpec as P

import sputnik_tpu as st
from sputnik_tpu.ops._common import interpret_kernels
from sputnik_tpu.parallel import RowPartition

NDEV = 8


@pytest.fixture(scope="module")
def mesh():
    devs = jax.devices()
    if len(devs) < NDEV:
        pytest.skip(f"need {NDEV} devices")
    return Mesh(np.array(devs[:NDEV]), ("sp",))


# ---------------------------------------------------------------------------
# jaxpr taint walker
# ---------------------------------------------------------------------------


def _subjaxprs(eqn):
    out = []
    for v in eqn.params.values():
        vs = v if isinstance(v, (list, tuple)) else [v]
        for x in vs:
            if hasattr(x, "jaxpr"):          # ClosedJaxpr
                out.append(x.jaxpr)
            elif hasattr(x, "eqns"):         # raw Jaxpr
                out.append(x)
    return out


class OverlapReport:
    def __init__(self):
        self.ppermute_after_pallas = 0   # collective serialized on kernel
        self.pallas_total = 0
        self.pallas_after_ppermute = 0   # kernel serialized on collective
        self.ppermute_total = 0


def _analyze(jaxpr, in_k, in_c, rep):
    """Propagate two taints through one jaxpr: ``k`` = depends on a
    pallas_call output, ``c`` = depends on a ppermute output. ``in_k`` /
    ``in_c`` are per-invar booleans. Returns per-outvar taints."""
    kt = dict(zip(jaxpr.invars, in_k))
    ct = dict(zip(jaxpr.invars, in_c))

    def get(d, v):
        return bool(getattr(v, "count", None) is not None and d.get(v))

    for eqn in jaxpr.eqns:
        ik = [get(kt, v) for v in eqn.invars]
        ic = [get(ct, v) for v in eqn.invars]
        name = eqn.primitive.name
        ok = any(ik)
        oc = any(ic)
        subs = _subjaxprs(eqn)
        if name == "pallas_call":
            # (carries its kernel body as a 'jaxpr' param — an op, not
            # a call boundary)
            rep.pallas_total += 1
            if oc:
                rep.pallas_after_ppermute += 1
            ok = True
        elif name == "ppermute":
            rep.ppermute_total += 1
            if ok:
                rep.ppermute_after_pallas += 1
            oc = True
        elif name == "scan" and subs:
            # step-local: the carry enters untainted (the per-step
            # schedule is what overlap is about)
            body = subs[0]
            n = len(body.invars)
            _analyze(body, [False] * n, [False] * n, rep)
        elif subs:
            handled = False
            for sub in subs:
                n = len(sub.invars)
                if (n == len(eqn.invars)
                        and len(sub.outvars) == len(eqn.outvars)):
                    bk, bc = _analyze(sub, ik, ic, rep)
                    for v, a, b in zip(eqn.outvars, bk, bc):
                        kt[v] = a or ok
                        ct[v] = b or oc
                    handled = True
                else:
                    _analyze(sub, [False] * n, [False] * n, rep)
            if handled:
                continue
        for v in eqn.outvars:
            kt[v] = ok
            ct[v] = oc
    return ([get(kt, v) for v in jaxpr.outvars],
            [get(ct, v) for v in jaxpr.outvars])


def overlap_report(fn, *args) -> OverlapReport:
    # traced on the kernel route (what runs on the GPU): each kernel is a
    # pallas_call in the jaxpr
    with interpret_kernels():
        jx = jax.make_jaxpr(fn)(*args)
    rep = OverlapReport()
    n = len(jx.jaxpr.invars)
    _analyze(jx.jaxpr, [False] * n, [False] * n, rep)
    return rep


# ---------------------------------------------------------------------------
# fixtures: banded kv-sharded flash, halo spmm, ring
# ---------------------------------------------------------------------------


def _window_mask(s, w):
    i = np.arange(s)[:, None]
    j = np.arange(s)[None, :]
    return ((j <= i) & (j > i - w)).astype(np.float32)


def _kv_setup(mesh):
    from sputnik_tpu.parallel.flash_sharded import ShardedFlashSpec

    s, hd, R = 1024, 16, 2
    mask = _window_mask(s, 96)
    part = RowPartition(st.SparseTopology.from_dense_mask(mask), NDEV,
                        bm=8, balance=False)
    spec = ShardedFlashSpec(part, bm=8, bk=128, mesh=mesh, axis="sp")
    n_loc = s // NDEV
    rng = np.random.RandomState(0)
    q_sh = jnp.asarray(rng.randn(NDEV, R, n_loc, hd).astype(np.float32))
    k_sh = jnp.asarray(rng.randn(NDEV, R, n_loc, hd).astype(np.float32))
    v_sh = jnp.asarray(rng.randn(NDEV, R, n_loc, hd).astype(np.float32))
    return spec, q_sh, k_sh, v_sh


def test_kv_sharded_overlap_dataflow(mesh):
    """Overlap split: no ppermute downstream of a kernel, AND at least
    one kernel pass (the interior one) independent of every ppermute.
    The monolithic path must show the serialization the split removes."""
    from sputnik_tpu.parallel.flash_sharded import (
        flash_attention_kv_sharded)

    spec, q_sh, k_sh, v_sh = _kv_setup(mesh)
    rep = overlap_report(
        lambda a, b, c: flash_attention_kv_sharded(spec, a, b, c),
        q_sh, k_sh, v_sh)
    assert rep.ppermute_total > 0 and rep.pallas_total >= 2
    assert rep.ppermute_after_pallas == 0
    assert rep.pallas_after_ppermute < rep.pallas_total  # interior free

    rep0 = overlap_report(
        lambda a, b, c: flash_attention_kv_sharded(spec, a, b, c,
                                                   overlap=False),
        q_sh, k_sh, v_sh)
    assert rep0.pallas_after_ppermute == rep0.pallas_total  # serialized


def test_kv_sharded_overlap_backward_dataflow(mesh):
    """The backward's interior dkv/dq kernels must not wait on reverse
    ppermutes either (those route halo cotangents home afterwards)."""
    from sputnik_tpu.parallel.flash_sharded import (
        flash_attention_kv_sharded)

    spec, q_sh, k_sh, v_sh = _kv_setup(mesh)
    rep = overlap_report(
        jax.grad(lambda a, b, c: jnp.sum(
            flash_attention_kv_sharded(spec, a, b, c) ** 2),
            argnums=(0, 1, 2)),
        q_sh, k_sh, v_sh)
    assert rep.pallas_after_ppermute < rep.pallas_total


def test_kv_sharded_overlap_matches_monolithic(mesh):
    """The split path is numerically the same op (fwd + all grads)."""
    from sputnik_tpu.parallel.flash_sharded import (
        flash_attention_kv_sharded)

    spec, q_sh, k_sh, v_sh = _kv_setup(mesh)

    def loss(ov):
        return jax.jit(lambda a, b, c: jnp.sum(flash_attention_kv_sharded(
            spec, a, b, c, overlap=ov) ** 2))

    v1 = loss(True)(q_sh, k_sh, v_sh)
    v0 = loss(False)(q_sh, k_sh, v_sh)
    np.testing.assert_allclose(float(v1), float(v0), rtol=1e-5)
    g1 = jax.jit(jax.grad(lambda a, b, c: jnp.sum(
        flash_attention_kv_sharded(spec, a, b, c) ** 2),
        argnums=(0, 1, 2)))(q_sh, k_sh, v_sh)
    g0 = jax.jit(jax.grad(lambda a, b, c: jnp.sum(
        flash_attention_kv_sharded(spec, a, b, c, overlap=False) ** 2),
        argnums=(0, 1, 2)))(q_sh, k_sh, v_sh)
    for a, b in zip(g1, g0):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-4)


def test_spmm_halo_overlap_dataflow(mesh):
    """sharded_spmm_halo's split: interior SpMM pass independent of the
    halo ppermutes; no ppermute waits on a kernel."""
    from sputnik_tpu.parallel.sharded_ops import (ShardedPanelSpec,
                                                  sharded_spmm_halo)

    s = 1024
    mask = _window_mask(s, 200)
    topo = st.SparseTopology.from_dense_mask(mask)
    part = RowPartition(topo, NDEV, bm=128, balance=False)
    spec = ShardedPanelSpec(part, bm=128, bk=128, mesh=mesh, axis="sp")
    rng = np.random.RandomState(1)
    vals = rng.randn(topo.nnz_pad).astype(np.float32)
    panels = jnp.asarray(spec.stack_values(vals))
    dense_sh = jnp.asarray(
        rng.randn(NDEV, s // NDEV, 64).astype(np.float32))

    rep = overlap_report(
        lambda p, d: sharded_spmm_halo(spec, p, d), panels, dense_sh)
    assert rep.ppermute_total > 0 and rep.pallas_total == 2
    assert rep.ppermute_after_pallas == 0
    assert rep.pallas_after_ppermute == 1     # only the halo pass waits

    # and it is still the same op
    out = jax.jit(lambda p, d: sharded_spmm_halo(spec, p, d))(
        panels, dense_sh)
    A = np.zeros((s, s), np.float32)
    nz = topo.nnz
    A[np.asarray(topo.row_ids[:nz]),
      np.asarray(topo.column_indices[:nz])] = vals[:nz]
    ref = A @ np.asarray(dense_sh).reshape(s, 64)
    got = np.asarray(out)[:, : s // NDEV].reshape(s, -1)[:, :64]
    np.testing.assert_allclose(got, ref, atol=5e-4)


def test_ring_fwd_dataflow(mesh):
    """Ring forward: every per-step band rotation reads only the carry —
    never the flash kernel's output — so band t+1 streams while band t
    computes. The backward's dk/dv rotations are inherently serialized
    (this band's contribution must board before the accumulator leaves);
    assert the k/v rotations stay free there."""
    from sputnik_tpu.parallel.ring_flash import (RingFlashSpec,
                                                 ring_flash_attention)

    s, hd, R = 1024, 16, 2
    mask = np.tril(np.ones((s, s), np.float32))
    part = RowPartition(st.SparseTopology.from_dense_mask(mask), NDEV,
                        bm=8, balance=False)
    spec = RingFlashSpec(part, bm=8, bk=128, mesh=mesh, axis="sp")
    n_loc = s // NDEV
    rng = np.random.RandomState(2)
    q_sh = jnp.asarray(rng.randn(NDEV, R, n_loc, hd).astype(np.float32))
    k_sh = jnp.asarray(rng.randn(NDEV, R, n_loc, hd).astype(np.float32))
    v_sh = jnp.asarray(rng.randn(NDEV, R, n_loc, hd).astype(np.float32))

    rep = overlap_report(
        lambda a, b, c: ring_flash_attention(spec, a, b, c),
        q_sh, k_sh, v_sh)
    assert rep.ppermute_total == 2            # k and v, once per scan body
    assert rep.ppermute_after_pallas == 0
    assert rep.pallas_after_ppermute == 0     # kernel reads the carry

    repb = overlap_report(
        jax.grad(lambda a, b, c: jnp.sum(
            ring_flash_attention(spec, a, b, c) ** 2), argnums=(0, 1, 2)),
        q_sh, k_sh, v_sh)
    # bwd scan body: k/v rotations free (2), dk/dv rotations serialized (2)
    assert repb.ppermute_after_pallas == 2
    assert repb.ppermute_total == 2 + 2 + 2   # fwd replay + bwd body


def test_hierarchical_host_sp_mesh(mesh):
    """2 x 4 ("host", "sp") mesh: the kv-sharded attention runs MANUAL
    over sp while the host axis stays under GSPMD — host-sharded
    replica dims must reproduce the 1-axis-mesh result exactly (the
    dp-over-DCN x sp-over-ICI layout of comm_model's host tier)."""
    from sputnik_tpu.parallel.flash_sharded import (
        ShardedFlashSpec, flash_attention_kv_sharded)

    s, hd, R = 512, 16, 4           # R = replica dim, sharded over host
    sp = 4
    mask = _window_mask(s, 96)
    part = RowPartition(st.SparseTopology.from_dense_mask(mask), sp,
                        bm=8, balance=False)
    mesh1 = Mesh(np.array(jax.devices()[:sp]), ("sp",))
    spec1 = ShardedFlashSpec(part, bm=8, bk=128, mesh=mesh1, axis="sp")
    mesh2 = Mesh(np.array(jax.devices()[:8]).reshape(2, sp),
                 ("host", "sp"))
    spec2 = ShardedFlashSpec(part, bm=8, bk=128, mesh=mesh2, axis="sp")

    rng = np.random.RandomState(3)
    n_loc = s // sp
    q = jnp.asarray(rng.randn(sp, R, n_loc, hd).astype(np.float32))
    k = jnp.asarray(rng.randn(sp, R, n_loc, hd).astype(np.float32))

    out1 = jax.jit(lambda a, b, c: flash_attention_kv_sharded(
        spec1, a, b, c))(q, k, k)

    from jax.sharding import NamedSharding
    sh = NamedSharding(mesh2, P(None, "host", None, None))
    q2, k2 = jax.device_put(q, sh), jax.device_put(k, sh)
    f2 = jax.jit(lambda a, b, c: flash_attention_kv_sharded(
        spec2, a, b, c))
    out2 = f2(q2, k2, k2)
    np.testing.assert_allclose(np.asarray(out2), np.asarray(out1),
                               atol=1e-5)
    # grads flow through the two-axis mesh too (host grad all-reduce
    # handled by GSPMD)
    g = jax.jit(jax.grad(lambda a, b, c: jnp.sum(
        flash_attention_kv_sharded(spec2, a, b, c) ** 2),
        argnums=(0, 1, 2)))(q2, k2, k2)
    for t in g:
        assert np.isfinite(np.asarray(t)).all()

"""Smoke run of the main path on one GPU, through the public entry points.

    python chip_smoke.py               # one card: phases A, B, C
    python chip_smoke.py --ab          # also time kernel vs plain routes
    python chip_smoke.py --four-cards  # four cards: the parallel/ path only

Phase A (ops): panel and flat SpMM, transposed SpMM, SDDMM and sparse
softmax, plus one gradient through ``panel.spmm``, at 4096 x 4096 on an
element-random d=0.1 topology and a band of width 256. Each is compared
with the dense masked float32 product (or softmax) computed at ``highest``
precision, by the max-norm error relative to ``max|ref|``: <= 1e-4 with
the ops also at ``highest`` (only the summation order differs), <= 5e-3 at
default precision (TF32 keeps a 10-bit mantissa), <= 2e-2 for bf16
operands.

Phase A also runs the block-sparse flash attention (forward, dq and dk/dv
kernels) at the phase B attention shape (causal, 32 replicas, s=2048, hd
128) against dense masked softmax attention: output to 1e-4, gradients to
1e-3, both at ``highest``.

Phase B (training): ``SparseLM`` at vocab 32000, 6 layers, hidden 1024, 8
heads, ffn 4096, gelu, LayerNorm, residual, causal masks, batch 4, sequence
2048, default flash attention; 5 jitted AdamW steps of next-token
cross-entropy on tokens made from a seed. Every loss is finite and the last
is below the first; step 1's loss and global gradient norm at ``highest``
agree with ``attention_layout="xla"`` (dense masked attention) on the same
parameters to 1e-4 / 1e-3 relative.

Phase C (serving): ``LMServer`` over the trained parameters, 4 prompts of
512 tokens, 32 greedy new tokens, bf16 KV cache. The first decode step's
logits match the full forward's at that position to 1e-3 * max|logit| with
a float32 cache, and to the bf16-operand limit 2e-2 with the bf16 cache.

Phase D runs the ``gpu``-marked unit tests (``tests/test_gpu.py``: the
compiled kernels against their plain versions at small shapes) in this
process.

``--four-cards``: a dp x tp GSPMD train step of the phase B model on a
(2, 2) mesh against the one-card step, and ``flash_attention_sharded`` on a
4-card ``sp`` mesh at causal s=8192 against one-card
``fused_sparse_attention``.

Earlier lines print the card (``nvidia-smi`` name and power limit), the JAX
version and per-phase seconds; the last line is one JSON object
``{"ok": true, "device": {...}}``. Any failed check raises, so the exit code
is non-zero and no result line is printed. Without a GPU it fails at once.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time

import numpy as np

SEED = 0
N_OPS = 4096                    # phase A matrix size
TRAIN = (4, 2048)               # phase B batch, sequence
SERVE = (4, 512, 32)            # phase C prompts, prompt length, new tokens
SP = (8192, 8, 128)             # --four-cards sp: sequence, replicas, hd
WIDTH = dict(num_layers=6, hidden_size=1024, num_heads=8,
             ffn_hidden_size=4096, activation="gelu", use_layernorm=True,
             use_residual=True)
VOCAB = 32000


def _rel(out, ref) -> float:
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    if out.shape != ref.shape:
        raise AssertionError(f"shape {out.shape} != reference {ref.shape}")
    if not np.isfinite(out).all():
        raise AssertionError("non-finite values")
    return float(np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30))


def _check(name: str, out, ref, tol: float) -> None:
    err = _rel(out, ref)
    print(f"  {name:36s} rel err {err:.3e} (limit {tol:g})")
    if not err <= tol:
        raise AssertionError(f"{name}: rel err {err:.3e} > {tol:g}")


def _timed(fn, *args, iters: int = 5) -> float:
    """Milliseconds per call, best of 3 windows (block_until_ready)."""
    from sputnik_tpu.utils.profiling import measure

    return measure(fn, *args, iters=iters, repeats=3)


@contextlib.contextmanager
def _plain_route():
    import sputnik_tpu as st

    st.set_backend("xla")
    try:
        yield
    finally:
        st.set_backend("auto")


# ---------------------------------------------------------------------------
# Phase A: the op algebra.
# ---------------------------------------------------------------------------


def _topologies(n: int):
    import sputnik_tpu as st

    rng = np.random.RandomState(SEED)
    rand = (rng.rand(n, n) < 0.1).astype(np.float32)
    i = np.arange(n)
    band = (np.abs(i[:, None] - i[None, :] + 0.5) < 128).astype(np.float32)
    return {"random_d0.1": st.SparseTopology.from_dense_mask(rand),
            "band_256": st.SparseTopology.from_dense_mask(band)}


def phase_ops(ab: bool) -> None:
    import jax
    import jax.numpy as jnp

    import sputnik_tpu as st
    from sputnik_tpu.ops import panel_api as P

    n = N_OPS
    rng = np.random.RandomState(SEED + 1)
    hi = jax.lax.Precision.HIGHEST
    dense = jnp.asarray(rng.randn(n, n).astype(np.float32))
    g = jnp.asarray(rng.randn(n, n).astype(np.float32))
    lhs = jnp.asarray(rng.randn(n, 256).astype(np.float32))
    rhs = jnp.asarray(rng.randn(n, 256).astype(np.float32))
    for tname, topo in _topologies(n).items():
        print(f"phase A: {tname} nnz={topo.nnz}")
        rows = jnp.asarray(topo.row_ids[: topo.nnz])
        cols = jnp.asarray(topo.column_indices[: topo.nnz])
        vals = np.zeros(topo.nnz_pad, np.float32)
        vals[: topo.nnz] = rng.randn(topo.nnz)
        vals = jnp.asarray(vals)
        mask = jnp.zeros((n, n), bool).at[rows, cols].set(True)
        A = jnp.zeros((n, n), jnp.float32).at[rows, cols].set(
            vals[: topo.nnz])
        spec = P.PanelSpec(topo)
        panel = P.values_to_panel(topo, vals, spec.bm, spec.bk)

        @jax.jit
        def refs(A, mask, dense, g, lhs, rhs):
            sc = jnp.where(mask, A, -jnp.inf)
            sm = jnp.where(mask, jax.nn.softmax(sc, axis=-1), 0.0)
            sd = jnp.dot(lhs, rhs.T, precision=hi)
            return (jnp.dot(A, dense, precision=hi),
                    jnp.dot(A.T, g, precision=hi),
                    sd[rows, cols], jnp.nan_to_num(sm)[rows, cols],
                    jnp.dot(g, dense.T, precision=hi)[rows, cols])

        r_spmm, r_spmm_t, r_sddmm, r_sm, r_gpanel = refs(
            A, mask, dense, g, lhs, rhs)

        def flat(p):
            return P.panel_to_values(topo, p, spec.bm, spec.bk)[: topo.nnz]

        def make_ops():
            return {
                "panel.spmm": (jax.jit(lambda p, d: P.spmm(spec, p, d)),
                               (panel, dense), lambda o: o, r_spmm),
                "panel.spmm_t": (jax.jit(lambda p, d: P.spmm_t(spec, p, d)),
                                 (panel, g), lambda o: o, r_spmm_t),
                "panel.sddmm": (jax.jit(lambda a, b: P.sddmm(spec, a, b)),
                                (lhs, rhs), flat, r_sddmm),
                "panel.sparse_softmax": (
                    jax.jit(lambda p: P.sparse_softmax(spec, p)), (panel,),
                    flat, r_sm),
                "flat.spmm": (lambda v, d: st.spmm(topo, v, d), (vals, dense),
                              lambda o: o, r_spmm),
                "flat.sddmm": (lambda a, b: st.sddmm(topo, a, b), (lhs, rhs),
                               lambda o: o[: topo.nnz], r_sddmm),
                "flat.sparse_softmax": (
                    lambda v: st.sparse_softmax(topo, v), (vals,),
                    lambda o: o[: topo.nnz], r_sm),
            }

        ops = make_ops()
        for name, (fn, args, post, ref) in ops.items():
            with jax.default_matmul_precision("highest"):
                _check(f"{name} @highest", post(fn(*args)), ref, 1e-4)
            _check(f"{name} @default", post(fn(*args)), ref, 5e-3)
        _check("panel.spmm bf16",
               P.spmm(spec, panel.astype(jnp.bfloat16),
                      dense.astype(jnp.bfloat16)), r_spmm, 2e-2)

        # one gradient through panel.spmm: d(sum(out * g))
        grad = jax.jit(jax.grad(
            lambda p, d: jnp.sum(P.spmm(spec, p, d) * g), argnums=(0, 1)))
        with jax.default_matmul_precision("highest"):
            gp, gd = grad(panel, dense)
        _check("grad panel.spmm d_dense", gd, r_spmm_t, 1e-4)
        _check("grad panel.spmm d_panel", flat(gp), r_gpanel, 1e-4)

        if ab:                  # spmm_t has no kernel: plain on every route
            for name in ("panel.spmm", "panel.sddmm"):
                fn, args, _, _ = ops[name]
                t_k = _timed(fn, *args)
                with _plain_route():
                    fn_p = make_ops()[name][0]    # fresh trace, plain route
                    t_p = _timed(fn_p, *args)
                print(f"  AB {tname} {name}: kernel {t_k:.4f} ms, "
                      f"plain {t_p:.4f} ms")
            gfn = jax.jit(jax.grad(
                lambda p, d: jnp.sum(P.spmm(spec, p, d) * g),
                argnums=(0, 1)))
            t_k = _timed(gfn, panel, dense)
            with _plain_route():
                gfn_p = jax.jit(jax.grad(
                    lambda p, d: jnp.sum(P.spmm(spec, p, d) * g),
                    argnums=(0, 1)))
                t_p = _timed(gfn_p, panel, dense)
            print(f"  AB {tname} grad panel.spmm: kernel {t_k:.4f} ms, "
                  f"plain {t_p:.4f} ms")


def phase_attention(ab: bool) -> None:
    """Block-sparse flash attention (forward, dq, dk/dv kernels) at the
    phase B shape against dense masked softmax attention."""
    import jax
    import jax.numpy as jnp

    import sputnik_tpu as st
    from sputnik_tpu.models.transformer import flash_tiles
    from sputnik_tpu.ops import batched_panel as bp
    from sputnik_tpu.ops.fused_attention import fused_sparse_attention

    b, s = TRAIN
    h, hd = WIDTH["num_heads"], WIDTH["hidden_size"] // WIDTH["num_heads"]
    R = b * h
    causal = np.tril(np.ones((s, s), np.float32))
    mt = st.ManyMaskTopology.from_dense_masks(
        np.broadcast_to(causal, (b, s, s)).copy())
    bm, bk = flash_tiles(s, hd)
    spec = bp.BatchedPanelSpec.from_many_mask(mt, heads=h, bm=bm, bk=bk)
    rng = np.random.RandomState(SEED + 5)
    q, k, v, cot = (jnp.asarray(rng.randn(R, s, hd).astype(np.float32))
                    for _ in range(4))
    live = jnp.asarray(causal, bool)

    def dense(q, k, v):
        sc = jnp.einsum("rqd,rkd->rqk", q, k) / np.sqrt(hd)
        w = jax.nn.softmax(jnp.where(live, sc, -jnp.inf), axis=-1)
        return jnp.einsum("rqk,rkd->rqd", w, v)

    def fwd_bwd(attn):
        return jax.jit(lambda q, k, v: jax.vjp(attn, q, k, v)[1](cot)
                       + (attn(q, k, v),))

    flash = fwd_bwd(lambda q, k, v: fused_sparse_attention(spec, q, k, v))
    print(f"phase A: flash attention R={R} s={s} hd={hd} tiles {bm}x{bk}")
    with jax.default_matmul_precision("highest"):
        got = flash(q, k, v)
        want = fwd_bwd(dense)(q, k, v)
    for name, g_, w_, tol in zip(("dq", "dk", "dv", "out"), got, want,
                                 (1e-3, 1e-3, 1e-3, 1e-4)):
        _check(f"flash attention {name} @highest", g_, w_, tol)
    del got, want
    if ab:
        t_k = _timed(flash, q, k, v)
        with _plain_route():
            flash_p = fwd_bwd(
                lambda q, k, v: fused_sparse_attention(spec, q, k, v))
            t_p = _timed(flash_p, q, k, v)
        t_x = _timed(fwd_bwd(dense), q, k, v)
        print(f"  AB flash fwd+bwd: kernel {t_k:.4f} ms, plain {t_p:.4f} "
              f"ms (dense masked {t_x:.4f} ms)")


# ---------------------------------------------------------------------------
# Phase B: training.
# ---------------------------------------------------------------------------


def _lm(s: int, b: int = 4, layout: str = "flash"):
    from sputnik_tpu.models import SparseLM

    masks = np.broadcast_to(np.tril(np.ones((s, s), np.float32)),
                            (b, s, s)).copy()
    return SparseLM.from_masks(masks, vocab_size=VOCAB,
                               attention_layout=layout, **WIDTH)


def _loss_fn(lm):
    import jax
    import jax.numpy as jnp

    def loss(params, tokens):
        logits = lm.apply(params, tokens[:, :-1])
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        nll = -jnp.take_along_axis(logp, tokens[:, 1:, None], axis=-1)
        return jnp.mean(nll)

    return loss


def _grad_norm(grads):
    import jax
    import jax.numpy as jnp

    return jnp.sqrt(sum(jnp.sum(jnp.square(x))
                        for x in jax.tree.leaves(grads)))


def phase_train(ab: bool):
    import jax
    import jax.numpy as jnp
    import optax

    b, s = TRAIN
    t0 = time.perf_counter()
    lm = _lm(s, b)
    lm_x = _lm(s, b, layout="xla")
    tokens = jax.random.randint(jax.random.PRNGKey(SEED + 2), (b, s + 1), 0,
                                VOCAB, jnp.int32)
    params = lm.init(jax.random.PRNGKey(SEED), tokens[:, :-1])
    print(f"phase B: built + init in {time.perf_counter() - t0:.1f} s")

    # step 1 at highest precision: flash vs dense masked attention
    vg = jax.jit(jax.value_and_grad(_loss_fn(lm)))
    vg_x = jax.jit(jax.value_and_grad(_loss_fn(lm_x)))
    with jax.default_matmul_precision("highest"):
        l_f, g_f = vg(params, tokens)
        l_x, g_x = vg_x(params, tokens)
        n_f, n_x = float(_grad_norm(g_f)), float(_grad_norm(g_x))
    l_f, l_x = float(l_f), float(l_x)
    print(f"  step-1 @highest loss flash {l_f:.6f} xla {l_x:.6f}; "
          f"grad norm flash {n_f:.6f} xla {n_x:.6f}")
    if not abs(l_f - l_x) <= 1e-4 * abs(l_x):
        raise AssertionError(f"step-1 loss {l_f} vs xla {l_x}")
    if not abs(n_f - n_x) <= 1e-3 * abs(n_x):
        raise AssertionError(f"step-1 grad norm {n_f} vs xla {n_x}")
    del g_f, g_x

    tx = optax.adamw(1e-3)

    def make_step(loss_fn):
        @jax.jit
        def step(p, o, t):
            loss, grads = jax.value_and_grad(loss_fn)(p, t)
            updates, o = tx.update(grads, o, p)
            return optax.apply_updates(p, updates), o, loss
        return step

    step = make_step(_loss_fn(lm))
    p, o = params, tx.init(params)
    losses, times = [], []
    for _ in range(5):
        t1 = time.perf_counter()
        p, o, loss = step(p, o, tokens)
        losses.append(float(loss))
        times.append(time.perf_counter() - t1)
    print("  losses " + " ".join(f"{x:.5f}" for x in losses))
    print("  step seconds (first compiles) "
          + " ".join(f"{x:.4f}" for x in times))
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")

    if ab:
        p0, o0 = params, tx.init(params)
        t_k = _timed(step, p0, o0, tokens, iters=3)
        with _plain_route():
            step_p = make_step(_loss_fn(lm))
            t_p = _timed(step_p, p0, o0, tokens, iters=3)
        print(f"  AB train step: kernel {t_k:.3f} ms, plain {t_p:.3f} ms")
    return p


# ---------------------------------------------------------------------------
# Phase C: serving.
# ---------------------------------------------------------------------------


def phase_serve(params) -> None:
    import jax
    import jax.numpy as jnp

    from sputnik_tpu.models import LMServer

    b, P, n_new = SERVE
    lm = _lm(P, b)
    lm_full = _lm(P + 1, b)
    prompts = jax.random.randint(jax.random.PRNGKey(SEED + 3), (b, P), 0,
                                 VOCAB, jnp.int32)
    server = LMServer(lm, s_max=P + n_new, cache_dtype=jnp.bfloat16)
    t0 = time.perf_counter()
    out, _ = server.generate(params, prompts, n_new)
    out = np.asarray(out)
    print(f"phase C: generate {b}x{n_new} tokens in "
          f"{time.perf_counter() - t0:.2f} s (first call compiles)")
    if out.shape != (b, n_new) or not ((out >= 0) & (out < VOCAB)).all():
        raise AssertionError(f"bad generated tokens {out.shape}")

    # the first decode step (on generate's first token) against the full
    # forward over prompt + that token. The decode path itself is held to
    # 1e-3 with a float32 cache; the bf16 cache rounds every cached K/V to
    # an 8-bit mantissa (relative 2^-9), so it is held to the bf16-operand
    # limit of phase A.
    tok = jnp.asarray(out[:, 0])
    with jax.default_matmul_precision("highest"):
        seq = jnp.concatenate([prompts, tok[:, None]], axis=1)
        ref = jax.jit(lm_full.apply)(params, seq)[:, P]
        for dt, tol in ((jnp.float32, 1e-3), (jnp.bfloat16, 2e-2)):
            srv = LMServer(lm, s_max=P + n_new, cache_dtype=dt)
            caches = srv.init_caches(b)
            _, caches = jax.jit(srv.prefill)(params, prompts, caches)
            logits_d, _ = jax.jit(srv.decode_step)(params, tok, caches)
            _check(f"first decode step logits, {jnp.dtype(dt).name} cache",
                   logits_d, ref, tol)


# ---------------------------------------------------------------------------
# Phase D: the card-only unit tests.
# ---------------------------------------------------------------------------


def phase_card_tests() -> None:
    """``tests/test_gpu.py`` (the ``gpu``-marked tests) in this process, so
    one process holds the card. Runs last: the test configuration turns on
    64-bit types for the rest of the process."""
    import os

    import pytest

    class Count:
        passed = 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                self.passed += 1

    os.environ["SPUTNIK_TEST_GPU"] = "1"
    count = Count()
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "test_gpu.py")
    rc = pytest.main([path, "-q", "-m", "gpu", "-p", "no:cacheprovider"],
                     plugins=[count])
    print(f"phase D: {count.passed} card-only tests passed")
    if rc != 0 or count.passed == 0:
        raise AssertionError(f"card-only tests: exit {rc}, "
                             f"{count.passed} passed")


# ---------------------------------------------------------------------------
# --four-cards: the parallel/ path.
# ---------------------------------------------------------------------------


def phase_four_cards() -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as PS

    import sputnik_tpu as st
    from sputnik_tpu.ops import batched_panel as bp
    from sputnik_tpu.ops.fused_attention import fused_sparse_attention
    from sputnik_tpu.parallel import RowPartition
    from sputnik_tpu.parallel.flash_sharded import (ShardedFlashSpec,
                                                    flash_attention_sharded)

    devices = jax.devices()
    if len(devices) != 4:
        raise AssertionError(f"--four-cards needs 4 cards, found "
                             f"{len(devices)}")

    # (1) dp x tp GSPMD train step of the phase B model vs one card
    b, s = TRAIN
    lm = _lm(s, b)
    tokens = jax.random.randint(jax.random.PRNGKey(SEED + 2), (b, s + 1), 0,
                                VOCAB, jnp.int32)
    params = lm.init(jax.random.PRNGKey(SEED), tokens[:, :-1])
    loss_fn = _loss_fn(lm)
    vg = jax.jit(jax.value_and_grad(loss_fn))
    with jax.default_matmul_precision("highest"):
        l1, g1 = vg(params, tokens)
        n1 = float(_grad_norm(g1))
    l1 = float(l1)
    del g1
    mesh = Mesh(np.array(devices).reshape(2, 2), ("dp", "tp"))

    def shard(path, x):
        names = [getattr(k, "key", str(k)) for k in path]
        if x.ndim == 2 and ("query_key_value" in names or "to_4h" in names):
            return NamedSharding(mesh, PS(None, "tp"))   # column-parallel
        if x.ndim == 2 and ("to_h" in names or "dense" in names):
            return NamedSharding(mesh, PS("tp", None))   # row-parallel
        return NamedSharding(mesh, PS())
    params_sh = jax.device_put(
        params, jax.tree_util.tree_map_with_path(shard, params))
    tokens_sh = jax.device_put(tokens, NamedSharding(mesh, PS("dp", None)))
    t0 = time.perf_counter()
    with jax.default_matmul_precision("highest"):
        l4, g4 = vg(params_sh, tokens_sh)
        n4 = float(_grad_norm(g4))
    l4 = float(l4)
    print(f"four cards: dp x tp step in {time.perf_counter() - t0:.1f} s; "
          f"loss {l4:.6f} vs one card {l1:.6f}; grad norm {n4:.6f} vs "
          f"{n1:.6f}")
    if not abs(l4 - l1) <= 1e-4 * abs(l1):
        raise AssertionError(f"dp x tp loss {l4} vs one card {l1}")
    if not abs(n4 - n1) <= 1e-3 * abs(n1):
        raise AssertionError(f"dp x tp grad norm {n4} vs one card {n1}")
    del params_sh, g4

    # (2) sequence-parallel flash on a 4-card sp mesh, causal s=8192
    from sputnik_tpu.models.transformer import flash_tiles

    s, R, hd = SP
    bm, bk = flash_tiles(s, hd)
    mask = np.tril(np.ones((s, s), np.float32))
    topo = st.SparseTopology.from_dense_mask(mask)
    rng = np.random.RandomState(SEED + 4)
    q = jnp.asarray(rng.randn(R, s, hd).astype(np.float32))
    k = jnp.asarray(rng.randn(R, s, hd).astype(np.float32))
    v = jnp.asarray(rng.randn(R, s, hd).astype(np.float32))
    spec1 = bp.BatchedPanelSpec([topo], heads=R, bm=bm, bk=bk)
    part = RowPartition(topo, 4, bm=bm, balance=False)
    sp_mesh = Mesh(np.array(devices), ("sp",))
    spec4 = ShardedFlashSpec(part, bm=bm, bk=bk, mesh=sp_mesh, axis="sp")
    m_loc = part.m_loc                     # contiguous bands of m_loc rows

    def shard(x):
        x = jnp.pad(x, ((0, 0), (0, 4 * m_loc - s), (0, 0)))
        return x.reshape(R, 4, m_loc, hd).transpose(1, 0, 2, 3)

    def unshard(x):
        return x.transpose(1, 0, 2, 3).reshape(R, 4 * m_loc, hd)[:, :s]

    q_sh = shard(q)

    def loss1(qq):
        return jnp.sum(fused_sparse_attention(spec1, qq, k, v) ** 2)

    def loss4(qq_sh):
        return jnp.sum(flash_attention_sharded(spec4, qq_sh, k, v) ** 2)

    with jax.default_matmul_precision("highest"):
        o1 = jax.jit(lambda qq: fused_sparse_attention(spec1, qq, k, v))(q)
        o4 = jax.jit(lambda qq: flash_attention_sharded(spec4, qq, k, v))(
            q_sh)
        g1 = jax.jit(jax.grad(loss1))(q)
        g4 = jax.jit(jax.grad(loss4))(q_sh)
    o4, g4 = unshard(o4), unshard(g4)
    _check("flash_attention_sharded out", o4, o1, 1e-4)
    _check("flash_attention_sharded dq", g4, g1, 1e-3)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card parallel/ phase")
    ap.add_argument("--ab", action="store_true",
                    help="also time each kernel against the plain route")
    args = ap.parse_args()

    import jax

    from sputnik_tpu.utils import enable_compile_cache
    from sputnik_tpu.utils.device import (device_record, nvidia_smi_line,
                                          require_gpu)

    require_gpu()
    cache = enable_compile_cache()
    print(nvidia_smi_line())
    print(f"jax {jax.__version__}; compile cache {cache}")
    t_all = time.perf_counter()
    if args.four_cards:
        t0 = time.perf_counter()
        phase_four_cards()
        print(f"four-card phase: {time.perf_counter() - t0:.1f} s")
    else:
        t0 = time.perf_counter()
        phase_ops(args.ab)
        phase_attention(args.ab)
        print(f"phase A: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        params = phase_train(args.ab)
        print(f"phase B: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        phase_serve(params)
        print(f"phase C: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        phase_card_tests()
        print(f"phase D: {time.perf_counter() - t0:.1f} s")
    print(f"total: {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"ok": True, "device": device_record()}))


if __name__ == "__main__":
    main()

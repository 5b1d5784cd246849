"""Analytic communication/compute model for the sharded sparse ops.

The BASELINE north star asks for a multi-chip scaling-efficiency number
(>= 80% nnz/s on 2+ devices). The claim is grounded three ways (see
``benchmarks/scaling.py``):

  1. exact per-device link byte counts, derived from the SAME block
     metadata the kernels execute (not estimates of the algorithm — the
     actual ppermute slice sizes and psum payload shapes);
  2. this closed-form projection combining those bytes with the measured
     single-card kernel time and published link rates;
  3. a measured 1-card shard_map-machinery overhead on real hardware.

Collective cost conventions (standard ring algorithms, no overlap with
compute — conservative):

  * ``psum`` of a ``payload``-byte buffer over ``n`` devices moves
    ``2 * payload * (n-1)/n`` bytes through each device's link
    (reduce-scatter + all-gather).
  * a sliced ``ppermute`` halo shift moves exactly its slice bytes.
  * ``all_gather`` of per-device shards moves ``payload_local * (n-1)``.

Card numbers are NVIDIA's published H100 SXM figures (data sheet): 989
dense bf16 TFLOP/s, 3.35 TB/s HBM, NVLink 900 GB/s per card to the other
cards of its host, all to all — 450 GB/s each way. The cards of one host
are joined all to all, so a mesh axis inside a host can take any shape.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Chip", "H100", "psum_bytes", "all_gather_bytes",
           "spmm_comm_bytes", "spmm_halo_comm_bytes",
           "attention_comm_bytes", "project_scaling",
           "project_scaling_hier", "hier_halo_dcn_bytes",
           "hier_dp_grad_dcn_bytes", "OVERLAP_FRACTIONS"]


@dataclasses.dataclass(frozen=True)
class Chip:
    name: str
    bf16_flops: float          # peak dense tensor-core FLOP/s
    hbm_bw: float              # bytes/s
    link_oneway: float         # bytes/s one-way to the host's other cards
    # DCN (data-center network): the per-HOST egress rate shared by all
    # of the host's cards — below the aggregate intra-host link rate,
    # which is why the hierarchical layouts below keep halo/psum traffic
    # off it. NVIDIA DGX H100 figure: 8 x 400 Gb/s compute NICs per host
    # (4e11 B/s), 8 cards per host.
    dcn_host_oneway: float = 4.0e11
    chips_per_host: int = 8


H100 = Chip(name="h100", bf16_flops=9.89e14, hbm_bw=3.35e12,
            link_oneway=4.5e11)


def psum_bytes(payload_bytes: float, ndev: int) -> float:
    """Per-device link bytes for one psum (ring reduce-scatter+all-gather)."""
    if ndev <= 1:
        return 0.0
    return 2.0 * payload_bytes * (ndev - 1) / ndev


def all_gather_bytes(local_bytes: float, ndev: int) -> float:
    """Per-device link bytes to all-gather per-device shards."""
    if ndev <= 1:
        return 0.0
    return float(local_bytes) * (ndev - 1)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def spmm_comm_bytes(spec, q: int, *, itemsize: int = 4) -> dict:
    """Per-device link bytes for ``sharded_spmm`` (replicated dense RHS).

    Forward is communication-free; the backward's dense gradient is the
    transposed product ``A^T @ G`` whose per-device partials psum to the
    replicated ``[n_pad, q_pad]`` sum (``sharded_ops._local_spmm_t``).
    """
    ndev = spec.part.ndev
    q_pad = _round_up(max(q, 1), 128)
    payload = spec.n_pad * q_pad * itemsize
    return {"fwd": 0.0, "bwd": psum_bytes(payload, ndev),
            "payload_shapes": {"bwd_psum": (spec.n_pad, q_pad)}}


def spmm_halo_comm_bytes(spec, n_loc: int, q: int, *,
                         itemsize: int = 4) -> dict:
    """Per-device link bytes for ``sharded_spmm_halo`` (row-sharded RHS).

    Forward moves exactly the halo rows (``ShardedPanelSpec.halo_extents``,
    derived from the block metadata) via sliced ppermute shifts, or falls
    back to a dense all_gather when the halo spans the operand
    (``sharded_ops._halo_plan``). The backward reverses the same shifts
    (identical volume) for the dense grad.
    """
    ndev = spec.part.ndev
    q_pad = _round_up(max(q, 1), 128)
    lo, hi = spec.halo_extents(n_loc)
    dense_fallback = lo + hi >= (ndev - 1) * n_loc
    if dense_fallback:
        fwd = all_gather_bytes(n_loc * q_pad * itemsize, ndev)
        bwd = psum_bytes(spec.n_pad * q_pad * itemsize, ndev)
    else:
        fwd = (lo + hi) * q_pad * itemsize
        bwd = fwd  # reverse ppermutes, same slice sizes (vjp of assembly)
    return {"fwd": float(fwd), "bwd": float(bwd), "halo_rows": (lo, hi),
            "dense_fallback": bool(dense_fallback)}


def attention_comm_bytes(spec, hd: int, *, kv_replicas: int = 1,
                         itemsize: int = 4) -> dict:
    """Per-device link bytes for ``sparse_attention_sharded`` (and the
    fused ``flash_attention_sharded`` — same collective structure).

    Forward: none (q row-sharded, K/V replicated, scores stay local).
    Backward: dk and dv are partial sums over the shared key axis — two
    psums of ``[kv_replicas, n_pad, hd_pad]`` (``flash_sharded.
    _flash_sh_bwd`` / the sddmm+spmm VJP pair). ``kv_replicas`` is the
    K/V head-replica count — GQA divides it (group-sum happens locally
    BEFORE the psum), which divides the whole backward comm bill.
    """
    ndev = spec.part.ndev
    hd_pad = _round_up(max(hd, 1), 128)
    payload = kv_replicas * spec.n_pad * hd_pad * itemsize
    return {"fwd": 0.0, "bwd": 2.0 * psum_bytes(payload, ndev),
            "payload_shapes": {
                "dk_psum": (kv_replicas, spec.n_pad, hd_pad),
                "dv_psum": (kv_replicas, spec.n_pad, hd_pad)}}


def attention_halo_comm_bytes(spec, hd: int, n_loc: int, *,
                              kv_replicas: int = 1,
                              itemsize: int = 4) -> dict:
    """Per-device link bytes for ``flash_attention_kv_sharded`` (K/V
    key-sharded, halo-exchanged — the zero-psum variant).

    Forward: K and V each move their (lo, hi) halo rows via sliced
    ppermute (``ShardedFlashSpec.halo_extents``). Backward: dk/dv route
    back through the assembly's VJP — reverse ppermutes, identical
    volume; dq needs the already-assembled buffers (no extra comm).
    Comm is CONSTANT in sequence length (the structural fix for the
    replicated-K/V psum priced by ``attention_comm_bytes``). Full-span
    topologies fall back to all_gather.
    """
    ndev = spec.part.ndev
    hd_pad = _round_up(max(hd, 1), 128)
    plan = spec.halo_plan(n_loc)
    row_bytes = kv_replicas * hd_pad * itemsize
    if plan is None:
        fwd = 2.0 * all_gather_bytes(n_loc * row_bytes, ndev)
        return {"fwd": fwd, "bwd": fwd, "halo_rows": None,
                "dense_fallback": True}
    lo, hi = plan
    fwd = 2.0 * (lo + hi) * row_bytes          # K and V
    return {"fwd": float(fwd), "bwd": float(fwd), "halo_rows": (lo, hi),
            "dense_fallback": False}


def attention_ring_comm_bytes(n_loc: int, hd: int, ndev: int, *,
                              kv_replicas: int = 1,
                              itemsize: int = 4) -> dict:
    """Per-device link bytes for ``ring_flash_attention`` (full-causal
    sequence parallelism).

    Forward: ``ndev`` rotations of the K and V bands (one per scan step;
    total volume = the all_gather fallback's plus one band, but
    pipelined with compute and never materialised — peak per-device K/V
    is ONE band). Backward: the same K/V rotation plus the dk/dv
    accumulators riding the ring home (2x). No psum in either pass.
    """
    hd_pad = _round_up(max(hd, 1), 128)
    band = kv_replicas * n_loc * hd_pad * itemsize
    fwd = 2.0 * ndev * band           # K and V, ndev rotations
    return {"fwd": float(fwd), "bwd": float(2.0 * fwd),
            "peak_kv_bytes_per_dev": 2.0 * band}


def project_scaling(t1_ms: float, comm_bytes_per_dev: float,
                    ndev: int, chip: Chip = H100, *,
                    overlap_fraction: float = 0.0,
                    worst_device_factor: float = 1.0) -> dict:
    """Closed-form scaling projection for one op invocation.

    ``t1_ms``: measured single-chip kernel time for the full problem.
    Per-device compute shrinks linearly when the partition balances nnz;
    ``worst_device_factor`` (= ``nnz_balance(part)["max_over_mean"]``,
    1.0 for a balanced/zigzag partition) scales the compute term to the
    straggler device — SPMD steps at the slowest shard. Comm runs at the
    card's one-way link rate.

    ``overlap_fraction`` (``f``): the portion of the comm volume whose
    transfer is dataflow-independent of the kernels and can hide under
    compute (``tests/test_overlap.py`` proves the independence per path;
    see ``OVERLAP_FRACTIONS`` for the structural values). The overlapped
    part costs ``max(t_comp, f * t_comm)``; the remaining
    ``(1 - f) * t_comm`` is exposed. ``f = 0`` reproduces the old
    fully-serialized model, always reported as ``*_serial`` (the floor).

    Returns per-device time + efficiency ``t1 / (ndev * t)`` (== nnz/s
    scaling efficiency) for both the overlapped and serialized models.
    """
    if not 0.0 <= overlap_fraction <= 1.0:
        raise ValueError(f"overlap_fraction {overlap_fraction} not in "
                         "[0, 1]")
    if worst_device_factor < 1.0:
        raise ValueError(f"worst_device_factor {worst_device_factor} < 1")
    t_comp = t1_ms / ndev * worst_device_factor
    t_comm = comm_bytes_per_dev / chip.link_oneway * 1e3
    t_serial = t_comp + t_comm
    t = (max(t_comp, overlap_fraction * t_comm)
         + (1.0 - overlap_fraction) * t_comm)
    return {"ndev": ndev, "t_ms": t, "t_ms_serial": t_serial,
            "t_compute_ms": t_comp, "t_comm_ms": t_comm,
            "overlap_fraction": overlap_fraction,
            "worst_device_factor": worst_device_factor,
            "efficiency": t1_ms / (ndev * t) if ndev else 1.0,
            "efficiency_serial":
                t1_ms / (ndev * t_serial) if ndev else 1.0,
            "comm_fraction": t_comm / t_serial if t_serial else 0.0,
            "comm_exposed_ms": t - t_comp}


# Structural overlap fractions per sharded path: the share of each pass's
# link volume whose transfer has NO dataflow dependency on the kernels
# (asserted on the traced jaxpr in tests/test_overlap.py). The exposed
# remainder is inherent to the algebra, not the implementation:
#   * halo paths (spmm / flash kv-sharded): every halo row is prefetched
#     while the interior pass computes -> fwd fully overlappable. The
#     backward's reverse ppermutes carry kernel outputs (halo cotangents)
#     but run concurrently with the INTERIOR dkv/dq kernels -> modeled
#     fully overlappable as long as interior compute dominates (max()
#     keeps this honest when it does not).
#   * ring fwd: rotations read only the carry -> fully overlappable.
#   * ring bwd: k/v rotations free, dk/dv accumulators must board after
#     this band's kernels -> half the volume exposed.
#   * replicated-K/V psum paths: the psum consumes kernel outputs ->
#     nothing to prefetch (0.0).
OVERLAP_FRACTIONS = {
    "spmm_halo_fwd": 1.0, "spmm_halo_bwd": 1.0,
    "attention_halo_fwd": 1.0, "attention_halo_bwd": 1.0,
    "ring_fwd": 1.0, "ring_bwd": 0.5,
    "psum_bwd": 0.0,
}


def project_scaling_hier(t1_ms: float, ici_bytes_per_dev: float,
                         dcn_bytes_per_host: float, n_hosts: int,
                         chip: Chip = H100, *,
                         chips_per_host: int = 0,
                         overlap_ici: float = 0.0,
                         overlap_dcn: float = 0.0) -> dict:
    """Two-tier (N >= 2 hosts) scaling projection.

    Hierarchical layout assumption: the fast-changing axis (sp row
    partition / tp heads) lives INSIDE a host on NVLink; the across-host
    axis moves ``dcn_bytes_per_host`` through each host's shared DCN port
    per step. ``t1_ms`` is the measured single-chip time for the FULL
    problem; compute divides over all ``chips_per_host * n_hosts`` chips.
    Overlap fractions behave as in :func:`project_scaling`, per tier; the
    two transfers themselves run on disjoint fabrics and overlap each
    other freely, so the exposed time is the max of the two exposed
    remainders after hiding under compute. Serialized floors reported
    alongside.
    """
    cph = chips_per_host or chip.chips_per_host
    n_total = cph * n_hosts
    t_comp = t1_ms / n_total
    t_ici = ici_bytes_per_dev / chip.link_oneway * 1e3
    t_dcn = dcn_bytes_per_host / chip.dcn_host_oneway * 1e3
    t_serial = t_comp + t_ici + t_dcn

    def combine(tc, tx, f):
        return max(tc, f * tx) + (1.0 - f) * tx

    # each fabric hides under compute independently; the exposed parts
    # are charged SEQUENTIALLY even though the fabrics are disjoint
    # (conservative)
    exposed_ici = max(combine(t_comp, t_ici, overlap_ici) - t_comp, 0.0) \
        if t_ici else 0.0
    exposed_dcn = max(combine(t_comp, t_dcn, overlap_dcn) - t_comp, 0.0) \
        if t_dcn else 0.0
    t = t_comp + exposed_ici + exposed_dcn
    return {"n_hosts": n_hosts, "chips_per_host": cph, "ndev": n_total,
            "t_ms": t, "t_ms_serial": t_serial, "t_compute_ms": t_comp,
            "t_ici_ms": t_ici, "t_dcn_ms": t_dcn,
            "efficiency": t1_ms / (n_total * t) if t else 1.0,
            "efficiency_serial":
                t1_ms / (n_total * t_serial) if t_serial else 1.0,
            "dcn_fraction": t_dcn / t_serial if t_serial else 0.0}


def hier_halo_dcn_bytes(halo_rows: tuple, q: int, n_hosts: int, *,
                        itemsize: int = 4) -> float:
    """Per-host DCN bytes for a contiguous row/key partition spanning
    hosts: only the shards at each host BOUNDARY exchange their halo
    across DCN — every interior halo rides NVLink. A host in a 2-host line
    has one boundary; interior hosts of a longer line have two.

    This is the structural win of contiguous (banded) partitions at the
    host tier: DCN volume is O(halo), independent of both sequence
    length and per-host chip count.
    """
    if n_hosts <= 1:
        return 0.0
    lo, hi = halo_rows
    boundaries = 2 if n_hosts > 2 else 1
    return float((lo + hi) * q * itemsize * boundaries)


def hier_dp_grad_dcn_bytes(n_params: int, n_hosts: int, *,
                           itemsize: int = 4) -> float:
    """Per-host DCN bytes for data parallelism across hosts: one ring
    all-reduce of the gradient (2 * P * (H-1)/H) per step. The
    alternative to extending the row partition over DCN — wins when the
    parameter volume is smaller than the boundary activations, loses on
    large models; benchmarks/scaling.py prices both."""
    return psum_bytes(float(n_params) * itemsize, n_hosts)


def nnz_balance(part) -> dict:
    """Per-device nnz counts from a RowPartition (load-balance report)."""
    counts = np.array([s.nnz for s in part.shards], np.int64)
    return {"per_device": counts.tolist(),
            "max_over_mean": float(counts.max() / max(counts.mean(), 1.0))}

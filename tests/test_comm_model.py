"""Analytic comm/compute model (`parallel/comm_model.py`) invariants."""

import pytest
import numpy as np

import sputnik_tpu as st
from sputnik_tpu.parallel import RowPartition
from sputnik_tpu.parallel import comm_model as cm
from sputnik_tpu.parallel.sharded_ops import ShardedPanelSpec
from sputnik_tpu.patterns import local_window_topology


def _spec(topo, ndev, balance=True):
    part = RowPartition(topo, ndev, bm=8, balance=balance)
    return part, ShardedPanelSpec(part, bm=8, bk=128)


def test_collective_byte_formulas():
    assert cm.psum_bytes(100.0, 1) == 0.0
    assert cm.psum_bytes(100.0, 2) == 100.0          # 2 * 100 * 1/2
    assert cm.psum_bytes(100.0, 4) == 150.0          # 2 * 100 * 3/4
    assert cm.all_gather_bytes(10.0, 1) == 0.0
    assert cm.all_gather_bytes(10.0, 8) == 70.0


def test_banded_halo_constant_and_fallback():
    """Banded topology: ragged halo, extents == the (block-rounded)
    window at every ndev; random topology: dense all-gather fallback."""
    # s big enough that the block-rounded halo (<=128+128 rows at bk=128)
    # stays below a neighbour shard; at s=512/ndev=2 the fallback fires
    # legitimately (halo == the whole other shard)
    s = 1024
    btopo = local_window_topology(s, window=64)
    for ndev in (2, 4):
        _, spec = _spec(btopo, ndev, balance=False)
        c = cm.spmm_halo_comm_bytes(spec, s // ndev, 128)
        assert not c["dense_fallback"]
        lo, hi = c["halo_rows"]
        assert 0 < lo <= 128 and hi <= 128   # 64-window, bk=128 rounding
        assert c["fwd"] == (lo + hi) * 128 * 4
        assert c["bwd"] == c["fwd"]          # reverse ppermutes

    rng = np.random.RandomState(0)
    rtopo = st.SparseTopology.from_dense_mask(
        (rng.rand(s, s) < 0.3).astype(np.float32))
    _, spec = _spec(rtopo, 4)
    c = cm.spmm_halo_comm_bytes(spec, s // 4, 128)
    assert c["dense_fallback"]
    assert c["fwd"] == cm.all_gather_bytes((s // 4) * 128 * 4, 4)


def test_spmm_and_attention_payloads():
    s = 512
    topo = local_window_topology(s, window=64)
    _, spec = _spec(topo, 4, balance=False)
    sp = cm.spmm_comm_bytes(spec, 256)
    assert sp["fwd"] == 0.0                       # dense RHS replicated
    assert sp["bwd"] == cm.psum_bytes(spec.n_pad * 256 * 4, 4)
    at_mha = cm.attention_comm_bytes(spec, 64, kv_replicas=4)
    at_gqa = cm.attention_comm_bytes(spec, 64, kv_replicas=1)
    assert at_mha["fwd"] == 0.0                   # fwd communication-free
    assert at_mha["bwd"] == 4 * at_gqa["bwd"]     # GQA divides the psum


def test_project_scaling_efficiency():
    # comm-free: perfect scaling at any ndev
    p = cm.project_scaling(8.0, 0.0, 8)
    assert abs(p["efficiency"] - 1.0) < 1e-12
    # comm equal to per-device compute: efficiency exactly 0.5
    chip = cm.H100
    comm_bytes = (8.0 / 8) * 1e-3 * chip.link_oneway
    p = cm.project_scaling(8.0, comm_bytes, 8)
    assert abs(p["efficiency"] - 0.5) < 1e-9
    # efficiency is monotone non-increasing in ndev for fixed comm
    effs = [cm.project_scaling(8.0, 1e6, n)["efficiency"]
            for n in (2, 4, 8)]
    assert effs[0] >= effs[1] >= effs[2]


def test_nnz_balance():
    s = 512
    topo = st.SparseTopology.from_dense_mask(
        np.tril(np.ones((s, s), np.float32)))
    part, _ = _spec(topo, 4)                      # balanced partitioner
    bal = cm.nnz_balance(part)
    assert len(bal["per_device"]) == 4
    assert bal["max_over_mean"] < 1.2


def test_project_scaling_overlap():
    chip = cm.H100
    # comm equal to per-device compute, fully overlappable -> hidden
    comm_bytes = (8.0 / 8) * 1e-3 * chip.link_oneway
    p = cm.project_scaling(8.0, comm_bytes, 8, overlap_fraction=1.0)
    assert abs(p["efficiency"] - 1.0) < 1e-9
    assert abs(p["efficiency_serial"] - 0.5) < 1e-9   # floor kept
    # half-overlappable ring-bwd style: exposed half remains
    p = cm.project_scaling(8.0, comm_bytes, 8, overlap_fraction=0.5)
    assert p["efficiency_serial"] < p["efficiency"] < 1.0
    # f=0 reproduces the serialized model exactly
    p = cm.project_scaling(8.0, comm_bytes, 8, overlap_fraction=0.0)
    assert abs(p["t_ms"] - p["t_ms_serial"]) < 1e-12
    with pytest.raises(ValueError):
        cm.project_scaling(8.0, comm_bytes, 8, overlap_fraction=1.5)


def test_project_scaling_hier():
    # no DCN traffic: reduces to the one-tier projection over all chips
    p = cm.project_scaling_hier(8.0, 0.0, 0.0, 2, chips_per_host=4)
    assert p["ndev"] == 8 and abs(p["efficiency"] - 1.0) < 1e-12
    # DCN traffic hurts more than the same bytes on NVLink
    b = 1e6
    ici_only = cm.project_scaling_hier(8.0, b, 0.0, 2, chips_per_host=4)
    dcn_only = cm.project_scaling_hier(8.0, 0.0, b, 2, chips_per_host=4)
    assert dcn_only["t_ms"] > ici_only["t_ms"]
    # overlap hides DCN under compute when compute dominates
    ov = cm.project_scaling_hier(8.0, 0.0, 1e4, 2, chips_per_host=4,
                                 overlap_dcn=1.0)
    assert abs(ov["efficiency"] - 1.0) < 1e-9
    assert ov["efficiency_serial"] < 1.0


def test_hier_dcn_bytes():
    # 2 hosts: one boundary; >2 hosts: two boundaries per interior host
    b2 = cm.hier_halo_dcn_bytes((64, 64), 128, 2)
    b4 = cm.hier_halo_dcn_bytes((64, 64), 128, 4)
    assert b2 == 128 * 128 * 4 and b4 == 2 * b2
    assert cm.hier_halo_dcn_bytes((64, 64), 128, 1) == 0.0
    # dp grad ring all-reduce formula
    assert cm.hier_dp_grad_dcn_bytes(1000, 2) == cm.psum_bytes(4000, 2)

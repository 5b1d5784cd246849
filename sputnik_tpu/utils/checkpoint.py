"""Checkpoint save/restore for sparse models.

The reference has no persistence at all (SURVEY.md §5). Here: orbax-backed
pytree checkpoints (the JAX-ecosystem standard), plus portable CSR export —
panel-layout value params are converted to flat CSR vectors keyed with the
topology shape so a checkpoint can be reloaded under a *different* block
tiling (tiles are an execution detail, not model state).
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np

__all__ = ["export_moe_csr", "import_moe_csr",
           "save_checkpoint", "restore_checkpoint",
           "export_csr", "import_csr"]


def _checkpointer():
    import orbax.checkpoint as ocp

    return ocp.PyTreeCheckpointer()


def save_checkpoint(path: str, tree: Any) -> None:
    """Save a pytree (e.g. flax params) to ``path`` (orbax format)."""
    _checkpointer().save(os.path.abspath(path), tree, force=True)


def restore_checkpoint(path: str, like: Any = None) -> Any:
    """Restore a pytree; ``like`` provides structure/dtypes if given."""
    ckpt = _checkpointer()
    if like is not None:
        import orbax.checkpoint as ocp

        return ckpt.restore(os.path.abspath(path),
                            restore_args=ocp.checkpoint_utils.construct_restore_args(like))
    return ckpt.restore(os.path.abspath(path))


def export_csr(layer, values_param) -> dict:
    """Panel/CSR value param of a ``SparseLinear`` -> portable dict with
    flat CSR arrays (topology + values), independent of block tiling."""
    t = layer.topology
    from ..ops import panel_api as P

    vp = np.asarray(values_param)  # dtype-preserving (bf16 serving)
    if layer.layout == "panel":
        spec = layer.spec()
        vals = P.panel_to_values_np(t, vp, spec.bm, spec.bk)
    else:
        vals = vp
    return {
        "m": t.m,
        "n": t.n,
        "row_offsets": np.asarray(t.row_offsets),
        "column_indices": np.asarray(t.column_indices[: t.nnz]),
        "values": vals[: t.nnz],
    }


def import_csr(layer, blob: dict):
    """Portable CSR dict -> value param in ``layer``'s layout. The layer's
    topology must match the stored pattern."""
    t = layer.topology
    if (blob["m"], blob["n"]) != (t.m, t.n):
        raise ValueError(
            f"shape mismatch: checkpoint {blob['m']}x{blob['n']} vs "
            f"layer {t.m}x{t.n}")
    if not np.array_equal(np.asarray(blob["row_offsets"]), t.row_offsets) or \
            not np.array_equal(np.asarray(blob["column_indices"]),
                               t.column_indices[: t.nnz]):
        raise ValueError("topology mismatch between checkpoint and layer")
    stored = np.asarray(blob["values"])
    vals = np.zeros(t.nnz_pad, stored.dtype)
    vals[: t.nnz] = stored
    if layer.layout == "panel":
        from ..ops import panel_api as P

        spec = layer.spec()
        return P.values_to_panel_np(t, vals, spec.bm, spec.bk)
    return vals


def _topo_blob(t, vals_flat) -> dict:
    return {
        "m": t.m,
        "n": t.n,
        "row_offsets": np.asarray(t.row_offsets),
        "column_indices": np.asarray(t.column_indices[: t.nnz]),
        "values": vals_flat[..., : t.nnz],
    }


def export_moe_csr(moe, params) -> dict:
    """``SparseMoE`` expert-bank value params (panel layout ``(E,) +
    panel_shape``, ``models/moe.py``) -> portable dict of flat CSR arrays
    per projection (values ``[E, nnz]``), independent of block tiling.
    Dtype-preserving (the converters are; bf16 serving weights stay
    bf16)."""
    return {
        "w_in": _topo_blob(moe.topo_in,
                           moe.flat_values(params["w_in_values"], "in")),
        "w_out": _topo_blob(moe.topo_out,
                            moe.flat_values(params["w_out_values"], "out")),
        "num_experts": moe.num_experts,
    }


def import_moe_csr(moe, blob: dict) -> dict:
    """Portable MoE CSR dict -> panel-layout expert value params for
    ``moe`` (``{"w_in_values": ..., "w_out_values": ...}``). The MoE's
    shared topologies must match the stored patterns."""
    if blob.get("num_experts", moe.num_experts) != moe.num_experts:
        raise ValueError(
            f"expert count mismatch: checkpoint {blob['num_experts']} vs "
            f"moe {moe.num_experts}")
    out = {}
    for which, name in (("in", "w_in_values"), ("out", "w_out_values")):
        t = moe.topo_in if which == "in" else moe.topo_out
        b = blob[f"w_{which}"]
        if (b["m"], b["n"]) != (t.m, t.n):
            raise ValueError(
                f"w_{which} shape mismatch: checkpoint "
                f"{b['m']}x{b['n']} vs moe {t.m}x{t.n}")
        if not np.array_equal(np.asarray(b["row_offsets"]),
                              t.row_offsets) or \
                not np.array_equal(np.asarray(b["column_indices"]),
                                   t.column_indices[: t.nnz]):
            raise ValueError(f"w_{which} topology mismatch between "
                             "checkpoint and moe")
        stored = np.asarray(b["values"])
        if stored.shape[0] != moe.num_experts:
            raise ValueError(
                f"w_{which} expert dim {stored.shape[0]} != "
                f"{moe.num_experts}")
        flat = np.zeros((moe.num_experts, t.nnz_pad), stored.dtype)
        flat[:, : t.nnz] = stored
        out[name] = moe.panel_values(flat, which)
    return out

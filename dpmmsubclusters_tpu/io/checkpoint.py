"""Checkpoint save/load.

Equivalent of the reference's JLD2 checkpoints
(``src/dp-parallel-sampling.jl:396-401,450-455``; ``src/ds.jl:60-66,85-92``):
like the reference's ``pts_less_group``, checkpoints store labels,
sub-labels, the full cluster table, the PRNG key and the step -- but NOT the
points; resume re-supplies the data.  Format is a single ``.npz`` (flat
pytree paths as keys) plus a JSON-encoded config -- no Julia-style
re-``include`` of a params file is needed to resume.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any

import numpy as np
import jax

from ..config import DPMMConfig

_SEP = "//"
# On-disk format version.  Bump on incompatible layout changes; the decoder
# below tolerates UNKNOWN config keys (a config field added or renamed after
# a checkpoint was written must not make old checkpoints unloadable).
FORMAT_VERSION = 1


def _decode_config(cfg_dict: dict) -> DPMMConfig:
    """Config decode with forward/backward tolerance: drop keys the current
    DPMMConfig doesn't know (written by a newer/older version) instead of
    exploding with a TypeError; missing keys fall back to defaults."""
    known = {f.name for f in dataclasses.fields(DPMMConfig)}
    unknown = sorted(set(cfg_dict) - known)
    if unknown:
        import warnings

        warnings.warn(
            f"checkpoint config carries unknown keys {unknown} "
            f"(written by a different version?); ignoring them",
            stacklevel=3,
        )
    return DPMMConfig(**{k: v for k, v in cfg_dict.items() if k in known})


def _flatten(tree: Any):
    flat, treedef = jax.tree_util.tree_flatten_with_path(tree)
    out = {}
    for path, leaf in flat:
        key = _SEP.join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        out[key] = np.asarray(jax.device_get(leaf))
    return out, treedef


def save_checkpoint(path: str, *, table, labels, sublabels, key, step: int,
                    shift, cfg: DPMMConfig, family_name: str, n_points: int,
                    scale=None):
    """Write the sampler state to ``path`` (.npz)."""
    tdict, _ = _flatten(table)
    payload = {f"table{_SEP}{k}": v for k, v in tdict.items()}
    # labels may arrive lane-blocked [N/128, 128] (device state) or flat
    # (host state); the on-disk format is always flat [n_points]
    payload["labels"] = np.asarray(jax.device_get(labels)).reshape(-1)[:n_points]
    payload["sublabels"] = (
        np.asarray(jax.device_get(sublabels)).reshape(-1)[:n_points]
    )
    payload["key"] = np.asarray(jax.device_get(key))
    payload["step"] = np.asarray(step)
    payload["shift"] = np.asarray(shift)
    if scale is not None:
        payload["scale"] = np.asarray(scale)
    payload["n_points"] = np.asarray(n_points)
    payload["meta"] = np.frombuffer(
        json.dumps(
            {"config": dataclasses.asdict(cfg), "family": family_name,
             "version": FORMAT_VERSION}
        ).encode(),
        dtype=np.uint8,
    )
    np.savez(path, **payload)


def save_checkpoint_distributed(path: str, *, table, labels, sublabels, key,
                                step: int, shift, cfg: DPMMConfig,
                                family_name: str, n_points_global: int,
                                n_local: int, scale=None):
    """Multi-process checkpoint: EVERY process calls this.

    Process 0 writes the master file ``path`` (replicated table + key +
    step + config; the label fields hold process 0's shard) and every
    process writes ``path.shard<i>.npz`` with its local label rows.  Resume via
    :func:`load_checkpoint_distributed` on the same process grid with the
    same per-process data rows (the reference's checkpoint-resume likewise
    re-distributes labels across the same worker set,
    src/dp-parallel-sampling.jl:428-447).
    """
    import jax

    proc = jax.process_index()
    lab_local = np.concatenate(
        [np.asarray(s.data) for s in labels.addressable_shards]
    ).reshape(-1)[:n_local]
    sub_local = np.concatenate(
        [np.asarray(s.data) for s in sublabels.addressable_shards]
    ).reshape(-1)[:n_local]
    np.savez(
        f"{path}.shard{proc}.npz",
        labels=lab_local,
        sublabels=sub_local,
        n_local=np.asarray(n_local),
        process=np.asarray(proc),
        num_processes=np.asarray(jax.process_count()),
        step=np.asarray(step),
    )
    if proc == 0:
        save_checkpoint(
            path, table=table, labels=lab_local, sublabels=sub_local,
            key=key, step=step, shift=shift, cfg=cfg,
            family_name=family_name, n_points=n_points_global, scale=scale,
        )


def load_checkpoint_distributed(path: str, n_local: "int | None" = None):
    """Returns (master dict as :func:`load_checkpoint`, local shard dict
    with this process's ``labels``/``sublabels``/``n_local``).

    Resuming on a DIFFERENT process count than the one that saved is a
    re-shard, not a redesign: the table is replicated and labels are
    per-point, so this process's labels are a contiguous slice of the
    global (process-order) label stream.  Pass ``n_local`` = the number of
    data rows THIS process will feed on resume; the per-process offsets are
    agreed via an all-gather of the new row counts.  With ``n_local=None``
    (or when the grid matches and the local row count is unchanged) the
    same-grid fast path reads only this process's shard file.  All shard
    files must be reachable from every process (shared filesystem), like
    the reference's re-read of the original data path on resume
    (src/dp-parallel-sampling.jl:428-447).
    """
    import jax

    proc = jax.process_index()
    master = load_checkpoint(path)
    if _shard_exists(path, proc):
        with np.load(f"{path}.shard{proc}.npz") as z:
            n_saved_procs = int(z["num_processes"])
            if n_saved_procs == jax.process_count() and (
                n_local is None or int(z["n_local"]) == n_local
            ):
                return master, {
                    "labels": z["labels"],
                    "sublabels": z["sublabels"],
                    "n_local": int(z["n_local"]),
                }
    else:
        with np.load(f"{path}.shard0.npz") as z:
            n_saved_procs = int(z["num_processes"])
    if n_local is None:
        raise ValueError(
            f"checkpoint was written by {n_saved_procs} processes; to "
            f"resume on {jax.process_count()} pass n_local (this process's "
            f"row count) so the label stream can be re-sharded"
        )
    # --- re-shard: concatenate saved shards, slice this process's rows ---
    labels, sublabels = [], []
    for i in range(n_saved_procs):
        with np.load(f"{path}.shard{i}.npz") as z:
            labels.append(z["labels"])
            sublabels.append(z["sublabels"])
    labels = np.concatenate(labels)
    sublabels = np.concatenate(sublabels)
    # agree on the new per-process offsets (row order is process order,
    # matching parallel.distributed.shard_points_global)
    from jax.experimental import multihost_utils

    counts = np.asarray(
        multihost_utils.process_allgather(np.asarray(n_local))
    ).reshape(-1)
    start = int(counts[:proc].sum())
    stop = start + int(n_local)
    if stop > len(labels) or int(counts.sum()) != len(labels):
        raise ValueError(
            f"re-shard row counts {counts.tolist()} (total "
            f"{int(counts.sum())}) do not cover the checkpoint's "
            f"{len(labels)} points"
        )
    return master, {
        "labels": labels[start:stop],
        "sublabels": sublabels[start:stop],
        "n_local": int(n_local),
    }


def _shard_exists(path: str, proc: int) -> bool:
    import os

    return os.path.exists(f"{path}.shard{proc}.npz")


def load_checkpoint(path: str):
    """Returns a dict with table (nested), labels, sublabels, key, step,
    shift, n_points, config (DPMMConfig), family (str)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"].tobytes()).decode())
        table: dict = {}
        for k in z.files:
            if not k.startswith(f"table{_SEP}"):
                continue
            parts = k.split(_SEP)[1:]
            node = table
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[k]
        # forward-compat: table fields added after a checkpoint was written
        # get their neutral default instead of breaking the pytree
        if "active" in table and "needs_smart" not in table:
            table["needs_smart"] = np.zeros_like(table["active"])
        out = {
            "table": table,
            "labels": z["labels"],
            "sublabels": z["sublabels"],
            "key": z["key"],
            "step": int(z["step"]),
            "shift": z["shift"],
            "scale": z["scale"] if "scale" in z.files else None,
            "n_points": int(z["n_points"]),
            "config": _decode_config(meta["config"]),
            "family": meta["family"],
            "version": int(meta.get("version", 0)),
        }
    return out

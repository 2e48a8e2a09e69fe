"""Checkpoint / resume for long flux accumulations.

The reference has no checkpointing (SURVEY §5.4); its closest analog is the
additive multi-run accumulation with a per-run seed bump
(rayTraceDisk.hpp:54). Here the accumulated flux channels + run counter are
plain arrays, so long 1e8+-ray campaigns snapshot after every mega-run and
resume exactly: the restored run_number reproduces the remaining runs'
seeds, so an interrupted campaign equals an uninterrupted one. A copy of
``viennaray_tpu/utils/checkpoint.py``; it reads and writes the port's
tracers."""

from __future__ import annotations

import json
import os

import numpy as np


def save_checkpoint(path: str, tracer, metadata: dict | None = None):
    """Snapshot a tracer's accumulated TracingData + run counter."""
    td = tracer.get_local_data()
    arrays = {}
    labels = []
    for i in range(td.num_vector_data):
        lbl = td.get_vector_data_label(i)
        labels.append(lbl)
        arrays[f"vec_{i}"] = np.asarray(td.get_vector_data(i))
    manifest = {
        "labels": labels,
        "run_number": tracer._run_number,
        "rng_seed": tracer._rng_seed,
        "metadata": metadata or {},
    }
    tmp = path + ".tmp.npz"
    np.savez(tmp, manifest=json.dumps(manifest), **arrays)
    os.replace(tmp, path)


def load_checkpoint(path: str, tracer):
    """Restore accumulated flux + run counter into a configured tracer."""
    with np.load(path, allow_pickle=False) as data:
        manifest = json.loads(str(data["manifest"]))
        td = tracer.get_local_data()
        for i, lbl in enumerate(manifest["labels"]):
            arr = data[f"vec_{i}"]
            try:
                idx = td.get_vector_data_index(lbl)
                td.set_vector_data(idx, arr, label=lbl)
            except KeyError:
                idx = td.add_vector_data(len(arr), lbl)
                td.set_vector_data(idx, arr, label=lbl)
    tracer._run_number = int(manifest["run_number"])
    return manifest["metadata"]

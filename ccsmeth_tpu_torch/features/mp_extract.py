"""Multiprocess feature extraction workers.

The reference dedicates ~7 CPU processes per GPU to Python-loop extraction
(SURVEY.md §3.1); this engine's vectorized extractor does ~450k sites/s on ONE
core, but multi-chip serving still wants extraction scaled out. This module is
deliberately jax-free so spawned workers never touch the TPU runtime: call_mods
hands holebatches to a ProcessPoolExecutor initialized with this module's
globals.
"""

from __future__ import annotations

from .extract import ExtractConfig, extract_read_features

_G: dict = {}


def init_worker(motifs, ecfg: ExtractConfig, dnacontigs, holeids_e, holeids_ne,
                refnames) -> None:
    _G["motifs"] = motifs
    _G["ecfg"] = ecfg
    _G["dnacontigs"] = dnacontigs
    _G["holeids_e"] = holeids_e
    _G["holeids_ne"] = holeids_ne
    _G["refnames"] = refnames


def extract_holebatch(records) -> list:
    """-> [(ReadFeatures | None, error_str | None)] aligned with the input batch."""
    out = []
    for rec in records:
        refname = (_G["refnames"][rec.ref_id] if rec.ref_id >= 0 else None)
        try:
            rf = extract_read_features(rec, _G["motifs"], _G["ecfg"],
                                       _G["dnacontigs"], _G["holeids_e"],
                                       _G["holeids_ne"], refname)
            out.append((rf, None))
        except Exception as e:  # noqa: BLE001
            out.append((None, "{}: {}".format(type(e).__name__, e)))
    return out

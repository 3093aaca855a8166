"""MM/ML tagging of BamRecords with per-read modification calls.

Parity with ccsmeth/_bam2modbam.py:187-226 (_convert_locs_to_mmtag,
_convert_probs_to_mltag, _refill_tags) and call_modifications.py:230-266
(_add_modinfo2alignedseg): MM tag 'C+m?,<deltas>;', ML bytes floor(p*256) cap 255,
fi/fp/ri/rp pulse tags stripped unless keep_pulse.
"""

from __future__ import annotations

import numpy as np

from ..bamio.bam import BamRecord
from ..utils.codecs import (
    convert_locs_to_mmtag,
    convert_probs_to_mltag,
    seq_to_bytes,
)

PULSE_TAGS = ("fi", "fp", "ri", "rp")


def add_mm_ml_to_record(rec: BamRecord, locs_probs: list[tuple[int, float]],
                        rm_pulse: bool = True, modbase: str = "C") -> bool:
    """Tag one record in place; returns True when MM/ML were added.

    locs_probs: (read_loc in forward-seq coords, prob_1) for this read's sites.
    Empty/failed encoding still strips pulse tags (reference behavior). On the
    reference's AssertionError path (a loc not hitting a modbase) the record keeps
    its calls off but is still emitted (call_modifications.py:260-264).
    """
    rec.drop_tags(("MM", "ML"))
    if rm_pulse:
        rec.drop_tags(PULSE_TAGS)
    if not locs_probs:
        return False
    fwd = rec.get_forward_sequence()
    locs_probs = sorted(locs_probs, key=lambda x: x[0])
    locs = [lp[0] for lp in locs_probs]
    probs = [lp[1] for lp in locs_probs]
    try:
        mm_values = convert_locs_to_mmtag(locs, seq_to_bytes(fwd), modbase)
    except AssertionError:
        return False
    ml_values = convert_probs_to_mltag(probs)
    rec.set_tag("MM", "Z", modbase + "+m?," + ",".join(map(str, mm_values)) + ";")
    rec.set_tag("ML", "BC", np.asarray(ml_values, dtype=np.uint8))
    return True

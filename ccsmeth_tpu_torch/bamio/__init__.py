from .bam import (BamHeader, BamReader, BamRecord, BamWriter, sort_bam,
                  sort_bam_in_memory)
from .bgzf import BgzfReader, BgzfWriter, create_text_gz, open_text_auto
from .bai import build_index, fetch_region, index_bam_if_needed

__all__ = [
    "BamHeader",
    "BamReader",
    "BamRecord",
    "BamWriter",
    "BgzfReader",
    "BgzfWriter",
    "create_text_gz",
    "open_text_auto",
    "sort_bam",
    "sort_bam_in_memory",
    "build_index",
    "fetch_region",
    "index_bam_if_needed",
]

from .extract import ExtractConfig, extract_read_features, features_to_tsv_rows
from .batch import FeatureBatch, batch_from_reads

__all__ = [
    "ExtractConfig",
    "extract_read_features",
    "features_to_tsv_rows",
    "FeatureBatch",
    "batch_from_reads",
]

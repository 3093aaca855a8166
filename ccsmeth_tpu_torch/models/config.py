"""Typed model configs (replacing the reference's per-flag argparse plumbing,
ccsmeth/ccsmeth.py:230-320)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class AttRNNConfig:
    """Config for the call_mods models (reference models.py:17-382,698-806).

    model_type selects the family exactly like the reference:
      attbigru2s/attbilstm2s   -> scalar-kinetics 2-strand RNN (ModelAttRNN)
      attbigru2s2/attbilstm2s2 -> embedded-kinetics 2-strand RNN (ModelAttRNN2)
      attbigru1s/attbilstm1s   -> single-strand RNN (ModelAttRNNss)
    """

    seq_len: int = 21
    num_layers: int = 3
    num_classes: int = 2
    dropout_rate: float = 0.5
    hidden_size: int = 256
    is_npass: bool = True
    is_sn: bool = False
    is_map: bool = False
    is_stds: bool = False
    model_type: str = "attbigru2s"

    @property
    def rnn_cell(self) -> str:
        return "lstm" if "lstm" in self.model_type else "gru"

    @property
    def two_strand(self) -> bool:
        return self.model_type.endswith(("2s", "2s2"))

    @property
    def embedded_kinetics(self) -> bool:
        return self.model_type.endswith("2s2")

    @property
    def feas_ccs(self) -> int:
        # reference models.py:39-47
        n = 2
        if self.is_stds:
            n += 2
        if self.is_npass:
            n += 1
        if self.is_sn:
            n += 4
        if self.is_map:
            n += 1
        return n


@dataclasses.dataclass(frozen=True)
class TransEncConfig:
    """transencoder2s config (reference models.py:451-620)."""

    seq_len: int = 21
    num_layers: int = 6
    num_classes: int = 2
    dropout_rate: float = 0.5
    d_model: int = 256
    nhead: int = 4
    dim_ff: int = 512
    is_npass: bool = True
    is_sn: bool = False
    is_map: bool = False
    is_stds: bool = False
    model_type: str = "transencoder2s"


@dataclasses.dataclass(frozen=True)
class AggrConfig:
    """call_freqb aggregate model config (reference models.py:625-694)."""

    seq_len: int = 11
    num_layers: int = 1
    num_classes: int = 1
    dropout_rate: float = 0.5
    hidden_size: int = 32
    binsize: int = 20
    model_type: str = "attbigru"

    @property
    def rnn_cell(self) -> str:
        return "lstm" if "lstm" in self.model_type else "gru"

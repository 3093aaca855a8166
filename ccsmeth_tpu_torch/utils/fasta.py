"""FASTA reference reading (reference utils/ref_reader.py:33-57).

Sequences are uppercased on load like the reference DNAReference.
"""

from __future__ import annotations


class DNAReference:
    def __init__(self, reffile: str):
        self._contignames: list[str] = []
        self._contigs: dict[str, str] = {}
        name = None
        chunks: list[str] = []
        with open(reffile, "r") as rf:
            for line in rf:
                if line.startswith(">"):
                    if name is not None:
                        self._contigs[name] = "".join(chunks)
                        self._contignames.append(name)
                    name = line.strip()[1:].split(" ")[0]
                    chunks = []
                else:
                    chunks.append(line.strip().upper())
            if name is not None:
                self._contigs[name] = "".join(chunks)
                self._contignames.append(name)

    def getcontigs(self) -> dict[str, str]:
        return self._contigs

    def getcontignames(self) -> list[str]:
        return self._contignames


def get_contig2len(ref_path: str) -> dict[str, int]:
    ref = DNAReference(ref_path)
    return {name: len(seq) for name, seq in ref.getcontigs().items()}

"""Lockstep FASTA pair reader.

Replicates the reference driver's input handling (test_prog.cpp:94-149):
the two files are read line-by-line in lockstep; a header line is any
line whose first character is one of ``> < / +`` *in both files at once*;
the header character encodes the sequence op (bit0 reverse, bit1
complement); all following lines up to the next header are concatenated
into one sequence.  Pair i aligns query[i] against target[i].
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

from agatha_jax.constants import OP_CHARS


@dataclasses.dataclass
class SeqPair:
    query: str
    target: str
    query_op: int
    target_op: int
    query_header: str = ""
    target_header: str = ""


def read_fasta_pairs(query_path: str, target_path: str) -> list[SeqPair]:
    """Read two FASTA files in lockstep into a list of pairs."""
    return list(iter_fasta_pairs(query_path, target_path))


def iter_fasta_pairs(query_path: str, target_path: str) -> Iterator[SeqPair]:
    with open(query_path) as qf, open(target_path) as tf:
        pair: SeqPair | None = None
        state = 0  # 0: before first header, 1: header seen, 2: in sequence
        for q_line, t_line in zip(qf, tf):
            q_line = q_line.rstrip("\n").rstrip("\r")
            t_line = t_line.rstrip("\n").rstrip("\r")
            q_op = OP_CHARS.find(q_line[0]) if q_line else -1
            t_op = OP_CHARS.find(t_line[0]) if t_line else -1
            if q_op >= 0 and t_op >= 0:
                if pair is not None and state == 2:
                    yield pair
                pair = SeqPair(
                    query="",
                    target="",
                    query_op=q_op,
                    target_op=t_op,
                    query_header=q_line[1:],
                    target_header=t_line[1:],
                )
                state = 1
            elif state == 1 or state == 2:
                assert pair is not None
                pair.query += q_line
                pair.target += t_line
                state = 2
            else:
                raise ValueError(
                    "query and target files should be FASTA with the same "
                    "number of sequences"
                )
        if pair is not None and state == 2:
            yield pair


def write_fasta(path: str, seqs: list[str], ops: list[int] | None = None,
                headers: list[str] | None = None) -> None:
    """Write sequences in the reference's indexed-pair format."""
    with open(path, "w") as f:
        for i, seq in enumerate(seqs):
            ch = OP_CHARS[ops[i]] if ops else ">"
            hdr = headers[i] if headers else f">> {i + 1}"
            f.write(f"{ch}{hdr}\n{seq}\n")

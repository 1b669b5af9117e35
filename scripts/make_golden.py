"""Regenerate tests/golden: a score.log fixture that exercises the DP.

The reference's de-facto correctness artifact is score.log over a real
long-read dataset (AGAThA.sh:44, test_prog.cpp:363-366); the bundled
dataset is stripped from this mount, so this script builds a synthetic
set dominated by NON-TRIVIAL homologous alignments (a fixture of
zero-score rows regression-tests nothing about the DP):

* ~48 homologous pairs, mixed lengths 60-700, divergence 3-25%,
  cycling through all 16 (query_op, target_op) combinations of the
  ``> < / +`` header ops (bit0 reverse, bit1 complement) — op'd
  sequences are written pre-padded to a multiple of 8 so the file op
  round-trips exactly through encode_padded's pad-then-reverse order;
* 2 Z-drop terminations: ~500 bp of near-identity followed by a long
  divergent tail on both sides, deep enough that max - current > z;
* N-run pairs (N scores -N_PENALTY), an exact match, a 1-base pair,
  and a handful of unrelated pairs (the zero-score negatives);
* a separate mini set (query2/target2/score2.log) for the canonical
  flags' blind spot: `-w 15 -z -1` drives the empty-slice termination
  (slice_start > slice_end, agatha_kernel.h:183-191) on a skewed pair
  without Z-drop racing it.

Scores come from the cross-validated vector oracle
(ops.sweep.align_one_sweep), NOT from the engine under test.

Usage: python scripts/make_golden.py [outdir]
"""
import _path  # noqa: F401  (repo-root shim, scripts/_path.py)
import os
import sys

import numpy as np

from agatha_jax.config import AlignConfig
from agatha_jax.io.fasta import write_fasta
from agatha_jax.ops.packing import encode_padded
from agatha_jax.ops.sweep import align_one_sweep

BASES = np.array(list("ACGT"))
COMP = str.maketrans("ACGTN", "TGCAN")


def rand_seq(rng, n, n_frac=0.0):
    s = BASES[rng.integers(0, 4, size=n)]
    if n_frac:
        s[rng.random(n) < n_frac] = "N"
    return "".join(s)


def mutate(rng, seq, div):
    sub, indel = div / 2, div / 4
    out = []
    for ch in seq:
        r = rng.random()
        if r < indel:
            continue
        if r < 2 * indel:
            out.append("ACGT"[rng.integers(0, 4)])
        out.append("ACGT"[rng.integers(0, 4)] if rng.random() < sub
                   else ch)
    return "".join(out) or "A"


def op_letters(seq, op):
    """File-side inverse of encode_padded's op: for sequences whose
    length is a multiple of 8 (pad = 0) the op is an involution in
    letter space, so storing op(seq) makes the reader decode seq."""
    assert op == 0 or len(seq) % 8 == 0
    if op & 0x1:
        seq = seq[::-1]
    if op & 0x2:
        seq = seq.translate(COMP)
    return seq


def pad8(seq, rng):
    k = (-len(seq)) % 8
    return seq + "".join(BASES[rng.integers(0, 4, size=k)])


def score_line(q, t, q_op, t_op, cfg):
    qc = encode_padded(q, q_op)
    tc = encode_padded(t, t_op)
    s, qe, te = align_one_sweep(qc, tc, len(q), len(t), cfg)
    return f"{s}\tquery_batch_end={qe}\ttarget_batch_end={te}\n"


def main():
    outdir = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        os.path.dirname(__file__), "..", "tests", "golden")
    rng = np.random.default_rng(20260820)
    cfg = AlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2)

    qs, ts, qops, tops = [], [], [], []

    def add(q, t, q_op=0, t_op=0):
        qs.append(q)
        ts.append(t)
        qops.append(q_op)
        tops.append(t_op)

    # 48 homologous pairs cycling all 16 op combinations x 3 rounds
    for i in range(48):
        q_op, t_op = (i // 4) % 4, i % 4
        n = int(rng.integers(60, 700))
        div = float(rng.uniform(0.03, 0.25))
        qa = rand_seq(rng, n, n_frac=0.02 if i % 5 == 0 else 0.0)
        if q_op:
            qa = pad8(qa, rng)
        ta = mutate(rng, qa, div)
        if t_op:
            ta = pad8(ta, rng)
        add(op_letters(qa, q_op), op_letters(ta, t_op), q_op, t_op)

    # 2 Z-drop terminations: near-identical head, divergent tails
    for n_head, n_tail in ((500, 600), (350, 700)):
        head = rand_seq(rng, n_head)
        add(head + rand_seq(rng, n_tail),
            mutate(rng, head, 0.04) + rand_seq(rng, n_tail))

    # special shapes
    add("A" * 64, "A" * 64)                        # exact long match
    add(rand_seq(rng, 80), rand_seq(rng, 80))      # unrelated short
    add("G", "C")                                  # 1-base mismatch
    add("T", "T")                                  # 1-base match
    add("N" * 40, rand_seq(rng, 40))               # all-N query
    h = rand_seq(rng, 120)                          # N-run interruption
    add(h, h[:50] + "N" * 12 + h[50:])
    for _ in range(8):                              # zero-ish negatives
        add(rand_seq(rng, int(rng.integers(40, 300))),
            rand_seq(rng, int(rng.integers(40, 300))))

    write_fasta(os.path.join(outdir, "query.fasta"), qs, qops)
    write_fasta(os.path.join(outdir, "target.fasta"), ts, tops)
    with open(os.path.join(outdir, "score.log"), "w") as f:
        for q, t, qo, to in zip(qs, ts, qops, tops):
            f.write(score_line(q, t, qo, to, cfg))

    # mini set: empty-slice termination under -w 15 -z -1
    cfg2 = AlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2,
                       band_width=15, z_threshold=-1)
    q2, t2 = [], []
    head = rand_seq(rng, 48)
    q2.append(head)
    t2.append(head + rand_seq(rng, 3000))  # skew >> bw: slice empties
    q2.append(rand_seq(rng, 200))
    t2.append(mutate(rng, q2[-1], 0.08))
    write_fasta(os.path.join(outdir, "query2.fasta"), q2)
    write_fasta(os.path.join(outdir, "target2.fasta"), t2)
    with open(os.path.join(outdir, "score2.log"), "w") as f:
        for q, t in zip(q2, t2):
            f.write(score_line(q, t, 0, 0, cfg2))

    n = len(qs)
    nz = sum(1 for line in open(os.path.join(outdir, "score.log"))
             if not line.startswith("0\t"))
    print(f"golden: {n} pairs, {nz} non-zero scores; mini: {len(q2)}")


if __name__ == "__main__":
    main()

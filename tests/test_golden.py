"""Golden score.log regression: CLI output vs checked-in oracle output.

The analogue of the reference's golden.log/out.log convention
(test_prog/Makefile:9-10,64-68) — but automated, with the golden file
produced by the cross-validated oracle rather than a prior binary run.
Regenerate with scripts/make_golden.py; the set is dominated by
non-trivial homologous alignments (all 16 op-header combinations,
Z-drop terminations, N runs) so any DP regression — scoring, band,
slice clipping, op decode — changes some line.  The mini set's
`-w 15 -z -1` invocation drives the empty-slice termination the
canonical flags cannot reach (Z-drop always races it there).
"""

import os
import subprocess
import sys

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _run_cli(tmp_path, extra, qfile, tfile):
    raw = tmp_path / "raw.log"
    proc = subprocess.run(
        [sys.executable, "-m", "agatha_jax.cli", "-p",
         "-m", "1", "-x", "4", "-q", "6", "-r", "2", *extra,
         os.path.join(GOLDEN, qfile),
         os.path.join(GOLDEN, tfile),
         str(raw)],
        capture_output=True, text=True, timeout=900,
        env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
             "HOME": "/root"},
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stdout


def test_cli_matches_golden(tmp_path):
    out = _run_cli(tmp_path, [], "query.fasta", "target.fasta")
    expected = open(os.path.join(GOLDEN, "score.log")).read()
    assert out == expected


def test_cli_matches_golden_empty_slice(tmp_path):
    out = _run_cli(tmp_path, ["-w", "15", "-z", "-1"],
                   "query2.fasta", "target2.fasta")
    expected = open(os.path.join(GOLDEN, "score2.log")).read()
    assert out == expected

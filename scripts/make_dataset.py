"""Generate the synthetic benchmark dataset in the reference's
indexed-pair FASTA format (README.md:41-52): query.fasta and ref.fasta
with pair i on matching indices; headers carry the op char.

The reference's bundled dataset is stripped from this mount
(.MISSING_LARGE_BLOBS), so this deterministic long-read seed-extension
workload stands in.
"""

import _path  # noqa: F401  (repo-root shim, scripts/_path.py)
import os
import sys


from agatha_jax.io.fasta import write_fasta  # noqa: E402
from agatha_jax.utils.workload import make_workload  # noqa: E402


_DECODE = {1: "A", 3: "C", 7: "G", 4: "T", 14: "N"}


def codes_to_str(codes, n):
    return "".join(_DECODE.get(int(c), "N") for c in codes[:n])


def main():
    out_dir = sys.argv[1] if len(sys.argv) > 1 else "output"
    n_pairs = int(sys.argv[2]) if len(sys.argv) > 2 else 512
    mean_len = int(sys.argv[3]) if len(sys.argv) > 3 else 10000
    os.makedirs(out_dir, exist_ok=True)
    encoded = make_workload(n_pairs, mean_len)
    qs = [codes_to_str(qc, ql) for qc, _tc, ql, _rl in encoded]
    ts = [codes_to_str(tc, rl) for _qc, tc, _ql, rl in encoded]
    write_fasta(os.path.join(out_dir, "query.fasta"), qs)
    write_fasta(os.path.join(out_dir, "ref.fasta"), ts)
    print(f"wrote {n_pairs} pairs (mean {mean_len} bp) to {out_dir}")


if __name__ == "__main__":
    main()

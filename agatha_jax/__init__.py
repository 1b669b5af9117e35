"""agatha_jax — guided sequence alignment in JAX, with a CUDA DP kernel.

Public API:

    from agatha_jax import AlignConfig, AlignEngine, SeqPair

    engine = AlignEngine(AlignConfig(match=1, mismatch=4,
                                     gap_open=6, gap_extend=2))
    result = engine.align_pairs([SeqPair(query, target, 0, 0)])
    result = engine.align(encoded, traceback=True)   # + CIGARs

See README.md for the CLI and benchmark harness, PARITY.md for the
reference-component mapping, and SURVEY.md for the blueprint.
"""

from agatha_jax.config import AlignConfig, EngineConfig  # noqa: F401


def __getattr__(name):
    # Lazy imports keep `import agatha_jax` free of jax/engine imports
    # (the native module and IO helpers have no heavy deps either).
    if name == "AlignEngine":
        from agatha_jax.engine import AlignEngine

        return AlignEngine
    if name == "AlignmentResult":
        from agatha_jax.engine import AlignmentResult

        return AlignmentResult
    if name == "SeqPair":
        from agatha_jax.io.fasta import SeqPair

        return SeqPair
    if name == "read_fasta_pairs":
        from agatha_jax.io.fasta import read_fasta_pairs

        return read_fasta_pairs
    if name == "iter_fasta_pairs":
        from agatha_jax.io.fasta import iter_fasta_pairs

        return iter_fasta_pairs
    raise AttributeError(name)


__all__ = [
    "AlignConfig",
    "EngineConfig",
    "AlignEngine",
    "AlignmentResult",
    "SeqPair",
    "read_fasta_pairs",
    "iter_fasta_pairs",
]

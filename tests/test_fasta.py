from agatha_jax.io.fasta import read_fasta_pairs


def test_lockstep_pairs_with_ops(tmp_path):
    qp = tmp_path / "q.fasta"
    tp = tmp_path / "t.fasta"
    qp.write_text(">>> 1\nACGT\nACGT\n<<< 2\nTTTT\n")
    tp.write_text(">>> 1\nGGGG\nGG\n/ x\nCCCC\n")
    pairs = read_fasta_pairs(str(qp), str(tp))
    assert len(pairs) == 2
    assert pairs[0].query == "ACGTACGT"  # multi-line concatenation
    assert pairs[0].target == "GGGGGG"
    assert pairs[0].query_op == 0 and pairs[0].target_op == 0
    assert pairs[1].query == "TTTT"
    assert pairs[1].target == "CCCC"
    assert pairs[1].query_op == 1   # '<' reverse natural
    assert pairs[1].target_op == 2  # '/' forward complement
    assert pairs[0].query_header == ">> 1"

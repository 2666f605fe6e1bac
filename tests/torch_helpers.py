"""Shared helpers of the port's tests (tests/test_torch_*.py): seeded
numpy workloads that go through both polypolish_tpu and
polypolish_tpu_torch."""

from __future__ import annotations

import numpy as np

import tests.synth as synth

DENSE_V = 8


def rand_events(n, num_positions, seed, sparse_frac=0.0, skew=False):
    """(pos int64, vocab int32) events; ``skew`` puts half of them in 1%
    of the positions (repeat-pileup shape), ``sparse_frac`` of them get
    sparse-tier ids >= 8."""
    rng = np.random.default_rng(seed)
    if skew:
        hot = rng.integers(0, max(1, num_positions // 100), size=n // 2)
        cold = rng.integers(0, num_positions, size=n - n // 2)
        pos = np.concatenate([hot, cold])
    else:
        pos = rng.integers(0, num_positions, size=n)
    vocab = rng.integers(0, DENSE_V, size=n)
    if sparse_frac:
        m = rng.random(n) < sparse_frac
        vocab = np.where(m, rng.integers(DENSE_V, DENSE_V + 40, size=n), vocab)
    return pos.astype(np.int64), vocab.astype(np.int32)


def write_polish_case(tmp_path, seed=5, genome_len=3000, n_reads=1500,
                      **kwargs):
    """A tests/synth.py polish case on disk: (assembly path, sam path)."""
    fasta, sam_text = synth.make_polish_case(
        seed=seed, genome_len=genome_len, n_reads=n_reads,
        **{"read_len": 60, "err": 0.08, "multi_frac": 0.4, **kwargs},
    )
    asm = tmp_path / f"a{seed}.fasta"
    asm.write_text(synth.fasta_text(fasta))
    sam = tmp_path / f"a{seed}.sam"
    sam.write_text(sam_text)
    return asm, sam


def parse_both(asm, sams):
    """The same SAM files parsed by both packages' native engines:
    ((jax ParsedRuns, port ParsedRuns), names, lens)."""
    from polypolish_tpu.io.fasta import load_fasta
    from polypolish_tpu.native import runs as jax_runs
    from polypolish_tpu.vocab import Vocab as JaxVocab
    from polypolish_tpu_torch.native import runs as torch_runs
    from polypolish_tpu_torch.vocab import Vocab

    fa = load_fasta(asm)
    names = [n for n, _, _ in fa]
    lens = {n: len(s) for n, _, s in fa}
    files = [str(s) for s in sams]
    jr = jax_runs.parse_runs(files, names, lens, JaxVocab(), 10, False)
    tr = torch_runs.parse_runs(files, names, lens, Vocab(), 10, False)
    return (jr, tr), names, lens

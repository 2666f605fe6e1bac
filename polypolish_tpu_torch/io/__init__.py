from polypolish_tpu_torch.io.fasta import load_fasta, write_fasta_record

__all__ = ["load_fasta", "write_fasta_record"]

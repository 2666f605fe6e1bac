from polypolish_tpu_torch.pipeline.polish import polish

__all__ = ["polish"]

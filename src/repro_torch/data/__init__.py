from repro_torch.data.pipeline import DataPipeline, shard_batch, synthetic_lm_batches

__all__ = ["DataPipeline", "shard_batch", "synthetic_lm_batches"]

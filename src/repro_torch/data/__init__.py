from repro_torch.data.pipeline import DataPipeline, shard_batch

__all__ = ["DataPipeline", "shard_batch"]

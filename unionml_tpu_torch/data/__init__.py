"""Input pipeline: host numpy data to device batches."""

from unionml_tpu_torch.data.pipeline import PrefetchIterator, to_host_arrays

__all__ = ["PrefetchIterator", "to_host_arrays"]

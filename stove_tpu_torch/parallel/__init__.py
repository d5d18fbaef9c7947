"""Data parallelism over torch.distributed (counterpart of
`stove_tpu/parallel`)."""

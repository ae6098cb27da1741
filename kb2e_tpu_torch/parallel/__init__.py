"""Multi-process execution over ``torch.distributed`` (counterpart of ``kb2e_tpu/parallel``)."""

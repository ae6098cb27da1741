from kb2e_tpu_torch.data.triples import Dataset, TripleSet, load_dataset  # noqa: F401

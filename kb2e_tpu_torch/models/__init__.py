from kb2e_tpu_torch.models.base import Model, Params, get_model  # noqa: F401

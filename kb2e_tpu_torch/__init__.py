"""kb2e_tpu_torch: the PyTorch and CUDA port of kb2e_tpu.

The package mirrors ``kb2e_tpu``'s layout and module names, so each module
has its counterpart at the same relative path.  It imports ``torch`` and
numpy only, never ``jax`` and nothing of ``kb2e_tpu``.  Entry points run on
``cuda`` unless the caller passes ``device="cpu"`` (CLI: ``--device cpu``);
the TPU's Pallas kernels become hand-written CUDA kernels under ``csrc/``.

It trains and evaluates TransE, TransH, TransR, CTransR and PTransE.
"""

__version__ = "0.1.0"

from kb2e_tpu_torch.config import EmbeddingConfig  # noqa: F401
from kb2e_tpu_torch.constants import Distance, Method  # noqa: F401
from kb2e_tpu_torch.models.base import Model, Params, get_model  # noqa: F401

"""Per-model main, analogue of the reference binary evalTransE
(transe/bin/evalTransE.cpp:9-18).  ``python -m kb2e_tpu_torch.cli.eval_transe``."""
from kb2e_tpu_torch.cli import eval as eval_cli


def main(argv=None):
    return eval_cli.main(argv, model_name="transe")


if __name__ == "__main__":
    main()

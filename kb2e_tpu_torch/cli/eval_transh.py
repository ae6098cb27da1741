"""Per-model main, analogue of the reference binary evalTransH
(transe/bin/evalTransE.cpp:9-18).  ``python -m kb2e_tpu_torch.cli.eval_transh``."""
from kb2e_tpu_torch.cli import eval as eval_cli


def main(argv=None):
    return eval_cli.main(argv, model_name="transh")


if __name__ == "__main__":
    main()

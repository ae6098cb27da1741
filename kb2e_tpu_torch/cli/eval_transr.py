"""Per-model main, analogue of the reference binary evalTransR
(transe/bin/evalTransE.cpp:9-18).  ``python -m kb2e_tpu_torch.cli.eval_transr``."""
from kb2e_tpu_torch.cli import eval as eval_cli


def main(argv=None):
    return eval_cli.main(argv, model_name="transr")


if __name__ == "__main__":
    main()

"""Per-model main, analogue of the reference binary trainTransH
(transe/bin/trainTransE.cpp:9-20).  ``python -m kb2e_tpu_torch.cli.train_transh``."""
from kb2e_tpu_torch.cli import train


def main(argv=None):
    return train.main(argv, model_name="transh")


if __name__ == "__main__":
    main()

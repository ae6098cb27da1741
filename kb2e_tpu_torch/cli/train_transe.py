"""Per-model main, analogue of the reference binary trainTransE
(transe/bin/trainTransE.cpp:9-20).  ``python -m kb2e_tpu_torch.cli.train_transe``."""
from kb2e_tpu_torch.cli import train


def main(argv=None):
    return train.main(argv, model_name="transe")


if __name__ == "__main__":
    main()

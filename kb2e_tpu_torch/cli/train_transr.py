"""Per-model main, analogue of the reference binary trainTransR
(transe/bin/trainTransE.cpp:9-20).  ``python -m kb2e_tpu_torch.cli.train_transr``;
``--seeddatadir`` / ``--seedmethod`` name the TransE warm start."""
from kb2e_tpu_torch.cli import train


def main(argv=None):
    return train.main(argv, model_name="transr")


if __name__ == "__main__":
    main()

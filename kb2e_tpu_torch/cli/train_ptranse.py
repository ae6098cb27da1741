"""Per-model main, analogue of the reference's train binaries
(transe/bin/trainTransE.cpp:9-20; the reference has no PTransE binary).
``python -m kb2e_tpu_torch.cli.train_ptranse``; ``--seeddatadir`` /
``--seedmethod`` name the TransE warm start, and the ``--path-*`` and
``--max-paths`` flags set the PCRA store and the path loss."""
from kb2e_tpu_torch.cli import train


def main(argv=None):
    return train.main(argv, model_name="ptranse")


if __name__ == "__main__":
    main()

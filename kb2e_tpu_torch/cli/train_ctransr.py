"""Per-model main, analogue of the reference's train binaries
(transe/bin/trainTransE.cpp:9-20; the reference has no CTransR binary).
``python -m kb2e_tpu_torch.cli.train_ctransr``; ``--seeddatadir`` /
``--seedmethod`` name the TransE warm start, and ``--seed`` also seeds the
k-means of the cluster centers."""
from kb2e_tpu_torch.cli import train


def main(argv=None):
    return train.main(argv, model_name="ctransr")


if __name__ == "__main__":
    main()

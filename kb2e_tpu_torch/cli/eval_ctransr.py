"""Per-model main, analogue of the reference's eval binaries
(transe/bin/evalTransE.cpp:9-18; the reference has no CTransR binary).
``python -m kb2e_tpu_torch.cli.eval_ctransr``; reads ``relation_clusters`` and
``cluster_centers`` beside the reference files."""
from kb2e_tpu_torch.cli import eval as eval_cli


def main(argv=None):
    return eval_cli.main(argv, model_name="ctransr")


if __name__ == "__main__":
    main()

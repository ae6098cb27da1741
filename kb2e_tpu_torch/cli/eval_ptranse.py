"""Per-model main, analogue of the reference's eval binaries
(transe/bin/evalTransE.cpp:9-18; the reference has no PTransE binary).
``python -m kb2e_tpu_torch.cli.eval_ptranse``; reads ``relation_inv`` (and
``comp_w`` for RNN) beside the reference files; ``--task relation`` adds the
test pairs' path evidence."""
from kb2e_tpu_torch.cli import eval as eval_cli


def main(argv=None):
    return eval_cli.main(argv, model_name="ptranse")


if __name__ == "__main__":
    main()

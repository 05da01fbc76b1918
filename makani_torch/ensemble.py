"""Ensemble training CLI (counterpart of ``makani_tpu/ensemble.py``) on one
card.

    python -m makani_torch.ensemble --yaml_config config/fourcastnet3.yaml \\
        --config base_config --ensemble_size 4 --run_num 0

``train.py``'s parser (``--device`` included) with ``--ensemble_size``,
which overrides the configuration's; the ``EnsembleTrainer`` trains,
validates, checkpoints and resumes as ``train.py``'s ``Trainer`` does.
``ensemble_fold_chunk`` is read from the configuration, as in the JAX
package. A parallel size other than 1 raises (multi-GPU is slice 6).
"""

from __future__ import annotations

import logging


def main(argv=None):
    """Train as the arguments say; returns the ``EnsembleTrainer``."""
    from makani_torch.train import build_params, check_one_process, get_parser

    parser = get_parser()
    parser.add_argument("--ensemble_size", type=int, default=None)
    args = parser.parse_args(argv)
    check_one_process(args)
    logging.basicConfig(level=logging.INFO)
    params = build_params(args)
    if args.ensemble_size is not None:
        params["ensemble_size"] = args.ensemble_size

    from makani_torch.utils.training.ensemble_trainer import EnsembleTrainer

    trainer = EnsembleTrainer(params, device=args.device)
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()

"""Inference and scoring CLI (counterpart of ``makani_tpu/inference.py``) on
one card.

    python -m makani_torch.inference --yaml_config ... --config ... --run_num 0

Scores the run's best checkpoint (else its latest) over the validation or
``--inf_data_path`` files and writes the metrics and the output files to
``--output_dir`` (default: the run's experiment directory). An
``ensemble_size`` above 1 in the configuration scores that many members of
each initial condition; ``--mask_file`` weighs the metrics with masks and
``--climatology_file`` scores anomalies against a per-date climatology.
"""

from __future__ import annotations

import logging


def main(argv=None):
    """Score as the arguments say; returns the ``Inferencer`` (its logs in
    ``logs``)."""
    from makani_torch.train import build_params, check_one_process, get_parser

    parser = get_parser()
    parser.add_argument("--output_dir", type=str, default=None)
    parser.add_argument("--inf_data_path", type=str, default=None)
    parser.add_argument("--start_date", type=str, default=None, help="first initial condition, ISO format YYYY-MM-DD")
    parser.add_argument("--end_date", type=str, default=None, help="last initial condition, ISO format YYYY-MM-DD")
    parser.add_argument("--mask_file", type=str, default=None, help="HDF5 of spatial masks for masked metrics")
    parser.add_argument("--climatology_file", type=str, default=None, help="HDF5 per-date climatology for anomaly scoring")
    parser.add_argument("--save_raw_forecasts", action="store_true")
    args = parser.parse_args(argv)
    check_one_process(args)
    logging.basicConfig(level=logging.INFO)
    params = build_params(args)
    if args.inf_data_path:
        params["inf_data_path"] = args.inf_data_path
    for key in ("start_date", "end_date", "mask_file", "climatology_file"):
        if getattr(args, key, None):
            params[key] = getattr(args, key)
    if args.save_raw_forecasts:
        params["save_raw_forecasts"] = True

    from makani_torch.utils.inference.inferencer import Inferencer

    inferencer = Inferencer(params, device=args.device)
    inferencer.log_score(inferencer.score_model(output_dir=args.output_dir or params.get("experiment_dir")))
    return inferencer


if __name__ == "__main__":
    main()

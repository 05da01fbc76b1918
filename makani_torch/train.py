"""Training CLI (counterpart of ``makani_tpu/train.py``) on one card.

    python -m makani_torch.train --yaml_config config/sfnonet.yaml \
        --config sfno_linear_73chq_sc3_layers8_edim384 --run_num 0

Runs on the card unless ``--device`` names another device (``--device cpu``
for the tests). The parallel sizes and the multi-host options raise unless
they ask for one process on one card: multi-GPU is slice 6. The JAX parser's
``--checkpoint_path`` and ``--pretrained_checkpoint_path``, which it reads
nowhere, are left out, so that argparse refuses them: a run resumes from its
own ``checkpoints/`` only.
"""

from __future__ import annotations

import argparse
import logging
import os
import tempfile


def get_parser():
    parser = argparse.ArgumentParser(description="makani-torch training")
    parser.add_argument("--yaml_config", type=str, default="config/sfnonet.yaml")
    parser.add_argument("--config", type=str, default="base_config")
    parser.add_argument("--run_num", type=str, default="00")
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--max_epochs", type=int, default=None)
    parser.add_argument("--h_parallel_size", type=int, default=1)
    parser.add_argument("--w_parallel_size", type=int, default=1)
    parser.add_argument("--parameters_split_size", type=int, default=1)
    parser.add_argument("--ensemble_parallel_size", type=int, default=1)
    parser.add_argument("--amp_mode", type=str, default=None, choices=[None, "none", "bf16"])
    parser.add_argument("--enable_synthetic_data", action="store_true")
    parser.add_argument("--multistep_count", type=int, default=None)
    parser.add_argument("--save_checkpoint", type=str, default=None)
    parser.add_argument("--multihost", action="store_true")
    parser.add_argument("--coordinator_address", type=str, default=None)
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    parser.add_argument("--device", type=str, default=None, help="torch device (default: the card, cuda)")
    return parser


def check_one_process(args):
    """Raise for the multi-host options: one process on one card."""
    if args.multihost or args.coordinator_address or (args.num_processes or 1) != 1:
        raise NotImplementedError("multi-host runs are not ported yet (slice 6, ROADMAP queue 1 item 12)")


def build_params(args):
    from makani_torch.utils.checkpoint_helpers import get_latest_checkpoint_version
    from makani_torch.utils.parse_dataset_metadata import parse_dataset_metadata
    from makani_torch.utils.yparams import YParams

    params = YParams(args.yaml_config, args.config)
    params["h_parallel_size"] = args.h_parallel_size
    params["w_parallel_size"] = args.w_parallel_size
    params["parameters_split_size"] = args.parameters_split_size
    params["ensemble_parallel_size"] = args.ensemble_parallel_size
    if args.batch_size is not None:
        params["batch_size"] = args.batch_size
    if args.max_epochs is not None:
        params["max_epochs"] = args.max_epochs
    if args.enable_synthetic_data:
        params["enable_synthetic_data"] = True
    if args.amp_mode is not None:
        params["compute_dtype"] = "bfloat16" if args.amp_mode == "bf16" else "float32"
    if args.multistep_count is not None:
        params["n_future"] = args.multistep_count - 1
    if args.save_checkpoint is not None:
        params["save_checkpoint"] = args.save_checkpoint

    meta_path = params.get("metadata_json_path")
    if meta_path and os.path.isfile(meta_path):
        parse_dataset_metadata(meta_path, params)
    elif params.get("in_channels") is None:
        n = len(params.get("channel_names"))
        params["in_channels"] = list(range(n))
        params["out_channels"] = list(range(n))

    exp_root = params.get("exp_dir", None) or os.path.join(tempfile.gettempdir(), "makani_torch_runs")
    exp_dir = os.path.join(exp_root, args.config, str(args.run_num))
    params["experiment_dir"] = exp_dir
    params["checkpoint_dir"] = os.path.join(exp_dir, "checkpoints")
    os.makedirs(exp_dir, exist_ok=True)

    # resume when the run has a checkpoint
    params["resuming"] = get_latest_checkpoint_version(params["checkpoint_dir"]) is not None
    return params


def main(argv=None):
    """Train as the arguments say; returns the ``Trainer``."""
    args = get_parser().parse_args(argv)
    check_one_process(args)
    logging.basicConfig(level=logging.INFO)
    params = build_params(args)

    from makani_torch.utils.training.deterministic_trainer import Trainer

    trainer = Trainer(params, device=args.device)
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()

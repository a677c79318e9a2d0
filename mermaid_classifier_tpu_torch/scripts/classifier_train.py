"""Local training entry point: committed YAML config dir -> trained, tracked,
registered artifact, through the port (head training on a CUDA card by
default).

The same config dir drives local and job runs (``train_job_entrypoint``);
the config's ``env:`` block is applied and the settings re-read before the
options are built, and the runner factory is a seam tests patch.

Usage:
    python -m mermaid_classifier_tpu_torch.scripts.classifier_train \\
        --config-dir path/to/config [--config-name training_config.yaml] \\
        [--run-name NAME] [--device cuda] [--allow-unpinned-torch]

``--device`` defaults to ``cuda`` and raises without a card (``--device
cpu`` runs on the host). The export gate refuses a torch other than
``inference.export.PARITY_PROVEN_TORCH`` unless ``--allow-unpinned-torch``
is given. The run is logged to ``settings.tracking_dir`` (``TRACKING_DIR``,
which the ``env:`` block may set).
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

logger = logging.getLogger("classifier_train")


def _resolve_runner_factory():
    """Import hook, patched by tests so the script runs without the
    training stack."""
    from mermaid_classifier_tpu_torch.train.runner import TrackingTrainingRunner

    return TrackingTrainingRunner


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--config-dir", required=True)
    parser.add_argument("--config-name", default="training_config.yaml")
    parser.add_argument("--run-name", default=None)
    parser.add_argument("--device", default="cuda",
                        help="torch device of head training (default cuda)")
    parser.add_argument("--allow-unpinned-torch", action="store_true",
                        help="export under a torch other than the parity-proven one")
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(name)s %(levelname)s %(message)s"
    )
    # A hung run must be diagnosable: SIGUSR1 dumps every thread's Python
    # stack to stderr without killing the process.
    import faulthandler
    import signal

    faulthandler.enable()
    faulthandler.register(signal.SIGUSR1, all_threads=True, chain=False)

    from mermaid_classifier_tpu_torch.models.extractor import _resolve_device

    device = _resolve_device(args.device)

    from mermaid_classifier_tpu_torch.utils.logging_config import (
        logging_config_for_script,
    )

    debug_file = logging_config_for_script("classifier_train")
    logger.info("debug log: %s", debug_file)

    config_path = Path(args.config_dir) / args.config_name
    from mermaid_classifier_tpu_torch.config.run_config import TrainingRunConfig

    config = TrainingRunConfig.from_yaml_path(config_path)
    config.apply_env()

    # The settings were read when their module was imported; re-read them
    # so the env block takes effect for this process.
    import mermaid_classifier_tpu_torch.config.settings as settings_mod

    settings_mod.reload_settings_from_env()

    dataset_options, training_options, tracking_options = config.build_options()

    runner_factory = _resolve_runner_factory()
    runner = runner_factory(
        dataset_options=dataset_options,
        training_options=training_options,
        tracking_options=tracking_options,
        device=str(device),
        enforce_torch_pin=not args.allow_unpinned_torch,
    )
    return_msg, registered = runner.run(run_name=args.run_name)
    logger.info("Final accuracy: %s", return_msg.acc if return_msg else None)
    logger.info("Registered model: %s", registered)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

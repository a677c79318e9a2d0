"""Container/job training entrypoint with staged failure markers, through
the port.

Emits a first debug dump (Python, torch and CUDA versions, the redacted
environment, the config directory's listing), then runs the same
config -> options -> runner flow as ``classifier_train`` with ENTER / FAIL /
EXIT markers around each stage, so a dead job's log states which stage
died. Exits 1 on any failure.

Usage:
    python -m mermaid_classifier_tpu_torch.scripts.train_job_entrypoint \\
        --config-dir path/to/config [--config-name training_config.yaml] \\
        [--run-name NAME] [--device cuda] [--allow-unpinned-torch]

It also runs as a file (``python
mermaid_classifier_tpu_torch/scripts/train_job_entrypoint.py``), which is
how a job launcher starts it.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import traceback
from pathlib import Path

if not __package__:
    # Run as a file (a job's entrypoint, ``python <path> ...``): the
    # repository root onto the path, as ``-m`` from the root would have it.
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

logger = logging.getLogger("train_job_entrypoint")

_REDACT = ("KEY", "SECRET", "TOKEN", "PASSWORD", "CREDENTIAL")


def _debug_dump(config_dir: Path) -> None:
    import platform

    logger.info("python %s on %s", platform.python_version(), platform.platform())
    try:
        import torch

        logger.info(
            "torch %s, CUDA %s, cuda available %s",
            torch.__version__, torch.version.cuda, torch.cuda.is_available(),
        )
    except Exception as exc:  # noqa: BLE001
        logger.info("torch unavailable at dump time: %s", exc)
    for key in sorted(os.environ):
        value = os.environ[key]
        if any(tok in key.upper() for tok in _REDACT):
            value = "<redacted>"
        logger.debug("env %s=%s", key, value)
    if config_dir.is_dir():
        logger.info("config dir %s: %s", config_dir,
                    sorted(p.name for p in config_dir.iterdir()))
    else:
        logger.warning("config dir %s does not exist", config_dir)


def _stage(name: str):
    class _Marker:
        def __enter__(self):
            logger.info("==== ENTER %s", name)

        def __exit__(self, exc_type, exc, tb):
            if exc_type is not None:
                logger.error("==== FAIL %s: %s", name, exc)
            else:
                logger.info("==== EXIT %s", name)
            return False

    return _Marker()


def _resolve_runner_factory():
    """Import hook for the runner class; tests patch this to drive the
    entrypoint without the training stack."""
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

    # stdout logging for job-log collectors.
    logging.basicConfig(
        stream=sys.stdout,
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(message)s",
    )
    config_dir = Path(args.config_dir)
    _debug_dump(config_dir)

    try:
        with _stage("load_config"):
            from mermaid_classifier_tpu_torch.config.run_config import (
                TrainingRunConfig,
            )

            config = TrainingRunConfig.from_yaml_path(
                config_dir / args.config_name
            )
        with _stage("apply_env"):
            config.apply_env()
            import mermaid_classifier_tpu_torch.config.settings as settings_mod

            settings_mod.reload_settings_from_env()
        with _stage("build_options"):
            dataset_options, training_options, tracking_options = (
                config.build_options()
            )
        with _stage("runner_run"):
            from mermaid_classifier_tpu_torch.models.extractor import (
                _resolve_device,
            )

            device = _resolve_device(args.device)
            runner_factory = _resolve_runner_factory()
            runner = runner_factory(
                dataset_options=dataset_options,
                training_options=training_options,
                tracking_options=tracking_options,
                device=str(device),
                enforce_torch_pin=not args.allow_unpinned_torch,
            )
            runner.run(run_name=args.run_name)
    except Exception:  # noqa: BLE001 - the job contract is exit 1 + traceback
        traceback.print_exc()
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

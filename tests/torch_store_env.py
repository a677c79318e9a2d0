"""The ``store_root_env`` fixture: ``OBJECT_STORE_ROOT`` set in the
environment and the port's settings re-read from it, as a process that
starts with the variable set sees it (``get_default_store`` reads
``settings.object_store_root`` only, as the JAX package's does). The
settings are put back afterwards."""

from __future__ import annotations

import pytest

from mermaid_classifier_tpu_torch.config import settings as tset


@pytest.fixture
def store_root_env(monkeypatch):
    saved = {n: getattr(tset.settings, n) for n in tset.Settings.field_names()}

    def set_root(root):
        monkeypatch.setenv("OBJECT_STORE_ROOT", str(root))
        tset.reload_settings_from_env()

    yield set_root
    for name, value in saved.items():
        setattr(tset.settings, name, value)

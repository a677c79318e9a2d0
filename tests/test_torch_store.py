"""The port's object store against the JAX package's: the same operations
(those of tests/data/test_store.py) on a ``LocalFSObjectStore`` of each
package give the same results and the same errors. Also the port's
``get_default_store`` from its settings (``OBJECT_STORE_ROOT`` in the
environment or a ``.env`` file once the settings are read, or
``override_settings``, which wins) as the JAX one reads it, and its
``s3://`` error."""

import os
import stat

import pytest

from mermaid_classifier_tpu.config import settings as jset
from mermaid_classifier_tpu.data import store as jstore
from mermaid_classifier_tpu_torch.config import settings as tset
from mermaid_classifier_tpu_torch.data import store as tstore


def _observe(fn):
    """fn()'s result, or its exception's type name and message."""
    try:
        out = fn()
    except Exception as exc:  # noqa: BLE001 - the error is the observation
        return ("raised", type(exc).__name__, str(exc).split(":")[0])
    return ("ok", sorted(out) if hasattr(out, "__next__") else out)


def _put_get_exists(mod, store, tmp):
    store.put_bytes("bucket", "a/b/c.bin", b"data")
    return [
        _observe(lambda: store.exists("bucket", "a/b/c.bin")),
        _observe(lambda: store.exists("bucket", "a/b/missing.bin")),
        _observe(lambda: store.get_bytes("bucket", "a/b/c.bin")),
        _observe(lambda: store.get_bytes("bucket", "nope")),
    ]


def _overwrite(mod, store, tmp):
    store.put_bytes("b", "k", b"v1")
    store.put_bytes("b", "k", b"v2")
    return [_observe(lambda: store.get_bytes("b", "k"))]


def _list_keys(mod, store, tmp):
    for key in ("s1/i1.npz", "s1/i2.npz", "s2/i3.npz"):
        store.put_bytes("b", key, b"x")
    (store.root / "b" / "s1" / "stray.part").write_bytes(b"junk")
    return [
        _observe(lambda: store.list_keys("b")),
        _observe(lambda: store.list_keys("b", prefix="s1/")),
        _observe(lambda: store.list_keys("empty_bucket")),
    ]


def _key_escape(mod, store, tmp):
    return [_observe(lambda: store.put_bytes("b", "../../etc/passwd", b"x"))]


def _download(mod, store, tmp):
    store.put_bytes("b", "k", b"payload")
    local = tmp / "dl" / "k.bin"
    store.download("b", "k", local)
    store.put_bytes("b", "k", b"v2-new")
    return [
        local.read_bytes(),
        sorted(p.name for p in local.parent.iterdir()),
        _observe(lambda: store.download("b", "nope", tmp / "x")),
    ]


def _delete(mod, store, tmp):
    store.put_bytes("b", "k", b"x")
    store.delete("b", "k")
    first = store.exists("b", "k")
    store.delete("b", "k")
    return [first, store.exists("b", "k")]


def _download_parallel(mod, store, tmp):
    store.put_bytes("b", "ok1", b"1")
    store.put_bytes("b", "ok2", b"2")
    jobs = {
        ("b", "ok1"): str(tmp / "out/ok1"),
        ("b", "ok2"): str(tmp / "out/ok2"),
        ("b", "missing"): str(tmp / "out/missing"),
    }
    failed = mod.download_parallel(store, jobs, max_workers=4)
    local = tmp / "out/ok1"
    store.put_bytes("b", "ok1", b"fresh")
    mod.download_parallel(store, {("b", "ok1"): str(local)}, skip_existing=True)
    kept = local.read_bytes()
    local.unlink()
    mod.download_parallel(store, {("b", "ok1"): str(local)}, skip_existing=False)
    return [failed, (tmp / "out/missing").exists(), kept, local.read_bytes()]


@pytest.mark.parametrize("scenario", [
    _put_get_exists, _overwrite, _list_keys, _key_escape, _download, _delete,
    _download_parallel,
], ids=lambda f: f.__name__.strip("_"))
def test_store_matches_jax(scenario, tmp_path):
    got = []
    for mod in (jstore, tstore):
        tmp = tmp_path / mod.__name__.split(".")[0]
        got.append(scenario(mod, mod.LocalFSObjectStore(tmp / "store"), tmp))
    assert got[1] == got[0]


def test_download_hardlinks_read_only(tmp_path):
    store = tstore.LocalFSObjectStore(tmp_path / "store")
    store.put_bytes("b", "k", b"feature-bytes")
    local = tmp_path / "cache" / "k.npz"
    store.download("b", "k", local)
    assert os.stat(local).st_ino == os.stat(store._path("b", "k")).st_ino
    mode = stat.S_IMODE(os.stat(local).st_mode)
    assert mode & (stat.S_IWUSR | stat.S_IWGRP | stat.S_IWOTH) == 0


def test_download_falls_back_to_copy_across_devices(tmp_path, monkeypatch):
    store = tstore.LocalFSObjectStore(tmp_path / "store")
    store.put_bytes("b", "k", b"cross-device-bytes")

    def no_link(src, dst):
        raise OSError(18, "Invalid cross-device link")  # EXDEV

    monkeypatch.setattr(os, "link", no_link)
    local = tmp_path / "othermount" / "k.bin"
    store.download("b", "k", local)
    assert local.read_bytes() == b"cross-device-bytes"
    assert list(local.parent.glob("*.part")) == []
    assert os.stat(local).st_ino != os.stat(store._path("b", "k")).st_ino


def test_default_store_from_environment(tmp_path, monkeypatch):
    """``OBJECT_STORE_ROOT`` reaches the store through the settings, as in
    the JAX package: set after the settings were read, it takes effect once
    they are re-read (``reload_settings_from_env``), in both packages."""
    saved = _saved_settings()
    try:
        with jset.override_settings(object_store_root=None), \
                tset.override_settings(object_store_root=None):
            monkeypatch.setenv("OBJECT_STORE_ROOT", str(tmp_path / "root"))
            for mod in (jstore, tstore):
                with pytest.raises(mod.ObjectStoreError):
                    mod.get_default_store()
        monkeypatch.chdir(tmp_path)
        jset.reload_settings_from_env()
        tset.reload_settings_from_env()
        jdefault, store = jstore.get_default_store(), tstore.get_default_store()
    finally:
        _restore_settings(saved)
    assert isinstance(store, tstore.LocalFSObjectStore)
    assert store.root == jdefault.root == tmp_path / "root"
    store.put_bytes("b", "k", b"x")
    assert (tmp_path / "root" / "b" / "k").read_bytes() == b"x"


@pytest.mark.parametrize("order", ["env_then_override", "override_then_env"])
def test_override_wins_over_environment_as_in_jax(tmp_path, monkeypatch, order):
    """The environment holds one root and ``override_settings`` another,
    set in either order: the override decides, and the port's root equals
    the JAX store's."""
    a, b = tmp_path / "a", tmp_path / "b"
    env_root, override_root = (a, b) if order == "env_then_override" else (b, a)
    saved = _saved_settings()
    try:
        monkeypatch.chdir(tmp_path)
        if order == "env_then_override":
            monkeypatch.setenv("OBJECT_STORE_ROOT", str(env_root))
            jset.reload_settings_from_env()
            tset.reload_settings_from_env()
        with jset.override_settings(object_store_root=str(override_root)), \
                tset.override_settings(object_store_root=str(override_root)):
            if order == "override_then_env":
                monkeypatch.setenv("OBJECT_STORE_ROOT", str(env_root))
            roots = (jstore.get_default_store().root,
                     tstore.get_default_store().root)
    finally:
        _restore_settings(saved)
    assert roots == (override_root, override_root)


def _saved_settings():
    return {mod: {n: getattr(mod.settings, n) for n in names}
            for mod, names in ((jset, list(jset.Settings.model_fields)),
                               (tset, tset.Settings.field_names()))}


def _restore_settings(saved):
    for mod, values in saved.items():
        for name, value in values.items():
            setattr(mod.settings, name, value)


@pytest.mark.parametrize("route", ["env_file", "override"])
def test_default_store_from_settings_matches_jax(tmp_path, monkeypatch, route):
    """With no OBJECT_STORE_ROOT in the environment, both packages take the
    root from their settings: a ``.env`` file re-read in place, or
    ``override_settings``. Each store reads what the other wrote."""
    monkeypatch.delenv("OBJECT_STORE_ROOT", raising=False)
    root = tmp_path / "root"
    saved = _saved_settings()
    try:
        if route == "env_file":
            monkeypatch.chdir(tmp_path)
            (tmp_path / ".env").write_text(f"OBJECT_STORE_ROOT={root}\n")
            jset.reload_settings_from_env()
            tset.reload_settings_from_env()
            got = (jstore.get_default_store(), tstore.get_default_store())
        else:
            with jset.override_settings(object_store_root=str(root)), \
                    tset.override_settings(object_store_root=str(root)):
                got = (jstore.get_default_store(), tstore.get_default_store())
    finally:
        _restore_settings(saved)
    jdefault, tdefault = got
    assert isinstance(tdefault, tstore.LocalFSObjectStore)
    assert tdefault.root == jdefault.root == root
    jdefault.put_bytes("b", "from_jax", b"j")
    tdefault.put_bytes("b", "from_port", b"t")
    assert tdefault.get_bytes("b", "from_jax") == b"j"
    assert jdefault.get_bytes("b", "from_port") == b"t"


def test_default_store_unset_and_s3_raise(monkeypatch):
    monkeypatch.delenv("OBJECT_STORE_ROOT", raising=False)
    with tset.override_settings(object_store_root=None):
        with pytest.raises(tstore.ObjectStoreError, match="OBJECT_STORE_ROOT"):
            tstore.get_default_store()
    with tset.override_settings(object_store_root="s3://reef-bucket"):
        with pytest.raises(tstore.ObjectStoreError, match="s3_store"):
            tstore.get_default_store()

"""The port's S3 store (``mermaid_classifier_tpu_torch/data/s3_store.py``)
on the cases of tests/data/test_s3_store.py, against the in-process fake
endpoint (tests/data/fake_s3_server.py): the AWS published SigV4 vector,
the session token, round trips, special-character keys, pagination,
retried 500s, ``download_parallel`` through the base ``download``, and
``get_default_store`` on ``s3://``. Also: the port's signer and the JAX
signer give identical headers for the same request and timestamp, and the
port's store and the JAX store read each other's objects."""

import datetime
import os
from pathlib import Path
from unittest import mock

import pytest

from mermaid_classifier_tpu.data import s3_store as js3
from mermaid_classifier_tpu_torch.config import settings as tset
from mermaid_classifier_tpu_torch.data import s3_store as ts3
from mermaid_classifier_tpu_torch.data.store import (
    ObjectStore,
    ObjectStoreError,
    download_parallel,
    get_default_store,
)

from tests.data.fake_s3_server import make_server

EMPTY = "e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855"
WHEN = datetime.datetime(2015, 8, 30, 12, 36, 0, tzinfo=datetime.timezone.utc)


def test_aws_published_get_vanilla_query_vector():
    creds = ts3.S3Credentials(
        access_key="AKIDEXAMPLE",
        secret_key="wJalrXUtnFEMI/K7MDENG+bPxRfiCYEXAMPLEKEY",
    )
    headers = ts3.sign_request(
        "GET",
        "https://iam.amazonaws.com/?Action=ListUsers&Version=2010-05-08",
        {"content-type": "application/x-www-form-urlencoded; charset=utf-8"},
        EMPTY, credentials=creds, region="us-east-1", service="iam", now=WHEN,
    )
    assert ("Signature=5d672d79c15b13162d9279b0855cfba6789a8edb4c82c400"
            "e06b5924a6f2b5d7") in headers["Authorization"]
    assert headers["x-amz-date"] == "20150830T123600Z"
    assert ("Credential=AKIDEXAMPLE/20150830/us-east-1/iam/aws4_request"
            in headers["Authorization"])


def test_session_token_is_signed_in():
    headers = ts3.sign_request(
        "GET", "https://bucket.example/key", {}, EMPTY,
        credentials=ts3.S3Credentials("AK", "SK", session_token="TOK"),
        region="us-east-1",
    )
    assert headers["x-amz-security-token"] == "TOK"
    assert "x-amz-security-token" in headers["Authorization"]


SIGNED = [
    ("GET", "https://iam.amazonaws.com/?Action=ListUsers&Version=2010-05-08",
     {"content-type": "application/x-www-form-urlencoded; charset=utf-8"}, "iam",
     None),
    ("PUT", "http://127.0.0.1:9000/feat/source%2012/image%3D5%2B6.features.npz",
     {"content-length": "4"}, "s3", "TOK"),
    ("GET", "http://127.0.0.1:9000/feat?list-type=2&prefix=s1%2F"
     "&continuation-token=3", {}, "s3", None),
    ("HEAD", "https://s3.eu-west-2.amazonaws.com/b/a/b%20c.npz",
     {"X-Custom": "  two   spaces "}, "s3", None),
    ("DELETE", "https://s3.us-east-1.amazonaws.com/b/k", {}, "s3", "session"),
]


@pytest.mark.parametrize("method,url,headers,service,token", SIGNED)
def test_signer_headers_equal_jax(method, url, headers, service, token):
    payload = "9f86d081884c7d659a2feaa0c55ad015a3bf4f1b2b0b822cd15d6c15b0f00a08"
    got = ts3.sign_request(
        method, url, headers, payload, region="eu-west-2", service=service,
        credentials=ts3.S3Credentials("AK", "SK/secret", session_token=token),
        now=WHEN)
    want = js3.sign_request(
        method, url, headers, payload, region="eu-west-2", service=service,
        credentials=js3.S3Credentials("AK", "SK/secret", session_token=token),
        now=WHEN)
    assert got == want


@pytest.fixture()
def fake():
    server, state, endpoint = make_server()
    try:
        yield state, ts3.S3ObjectStore(
            endpoint, credentials=ts3.S3Credentials("AK", "SK"),
            retry_backoff_s=0.01)
    finally:
        server.shutdown()


def test_put_get_exists_delete(fake):
    _, store = fake
    assert not store.exists("feat", "a/b.npz")
    store.put_bytes("feat", "a/b.npz", b"\x00\x01payload")
    assert store.exists("feat", "a/b.npz")
    assert store.get_bytes("feat", "a/b.npz") == b"\x00\x01payload"
    store.delete("feat", "a/b.npz")
    assert not store.exists("feat", "a/b.npz")


def test_get_missing_raises(fake):
    with pytest.raises(ObjectStoreError, match="not found"):
        fake[1].get_bytes("feat", "missing.npz")


def test_requests_carry_sigv4_auth(fake):
    state, store = fake
    store.put_bytes("feat", "k", b"x")
    assert state.auth_headers
    assert all(a is not None and "AWS4-HMAC-SHA256" in a for a in state.auth_headers)


def test_anonymous_store_sends_unsigned(fake):
    state, store = fake
    anon = ts3.S3ObjectStore(store.endpoint, credentials=None, retry_backoff_s=0.01)
    anon.put_bytes("feat", "k", b"x")
    assert state.auth_headers[-1] is None


@pytest.mark.parametrize("key", [
    "source 12/image=5+6.features.npz", "a/b%20c/d~e.npz", "ünïcode/ключ.npz",
])
def test_keys_with_special_characters(fake, key):
    _, store = fake
    store.put_bytes("feat", key, b"data")
    assert store.exists("feat", key)
    assert store.get_bytes("feat", key) == b"data"
    assert key in list(store.list_keys("feat"))


def test_list_with_prefix_and_pagination(fake):
    state, store = fake
    state.max_keys = 3
    for i in range(10):
        store.put_bytes("feat", f"s1/img{i:02d}.npz", b"d")
    store.put_bytes("feat", "s2/other.npz", b"d")
    assert list(store.list_keys("feat", prefix="s1/")) == [
        f"s1/img{i:02d}.npz" for i in range(10)]
    assert len([p for (_, p) in state.requests if "list-type=2" in p]) >= 4


def test_empty_listing(fake):
    assert list(fake[1].list_keys("feat")) == []


def test_transient_500s_are_retried(fake):
    state, store = fake
    store.put_bytes("feat", "k", b"v")
    state.failures_remaining = 2
    assert store.get_bytes("feat", "k") == b"v"


def test_exhausted_retries_raise(fake):
    state, store = fake
    state.failures_remaining = 99
    with pytest.raises(ObjectStoreError):
        store.get_bytes("feat", "k")


def test_download_parallel_through_base_download(fake, tmp_path):
    _, store = fake
    assert type(store).download is ObjectStore.download
    for i in range(6):
        store.put_bytes("feat", f"img{i}.npz", f"payload{i}".encode())
    jobs = {("feat", f"img{i}.npz"): str(tmp_path / f"img{i}.npz") for i in range(6)}
    jobs[("feat", "missing.npz")] = str(tmp_path / "missing.npz")
    assert download_parallel(store, jobs, max_workers=4) == {("feat", "missing.npz")}
    for i in range(6):
        assert (tmp_path / f"img{i}.npz").read_bytes() == f"payload{i}".encode()
    assert not list(tmp_path.glob("*.part"))


def test_bucket_resume_discipline(fake):
    _, store = fake
    done = {"s1/img0.features.npz", "s1/img2.features.npz"}
    for key in done:
        store.put_bytes("feat", key, b"features")
    existing = set(store.list_keys("feat", prefix="s1/"))
    assert existing == done
    assert [f"s1/img{i}.features.npz" for i in range(4)
            if f"s1/img{i}.features.npz" not in existing] == [
        "s1/img1.features.npz", "s1/img3.features.npz"]


def test_port_and_jax_stores_read_each_other(fake):
    _, store = fake
    jstore = js3.S3ObjectStore(store.endpoint, credentials=js3.S3Credentials("AK", "SK"),
                               retry_backoff_s=0.01)
    store.put_bytes("b", "from/port", b"p")
    jstore.put_bytes("b", "from/jax", b"j")
    assert store.get_bytes("b", "from/jax") == b"j"
    assert jstore.get_bytes("b", "from/port") == b"p"
    assert list(store.list_keys("b")) == list(jstore.list_keys("b"))


def test_s3_root_returns_s3_backend():
    env = {"OBJECT_STORE_ENDPOINT": "http://127.0.0.1:1", "AWS_REGION": "eu-west-2",
           "AWS_ACCESS_KEY_ID": "AK", "AWS_SECRET_ACCESS_KEY": "SK",
           "AWS_SESSION_TOKEN": "TOK"}
    with mock.patch.dict(os.environ, env), \
            tset.override_settings(object_store_root="s3://"):
        store = get_default_store()
    assert isinstance(store, ts3.S3ObjectStore)
    assert (store.endpoint, store.region) == ("http://127.0.0.1:1", "eu-west-2")
    assert store.credentials == ts3.S3Credentials("AK", "SK", "TOK")


def test_default_endpoint_and_anonymous_credentials():
    with mock.patch.dict(os.environ, {"AWS_REGION": "ap-south-1"}):
        for name in ("OBJECT_STORE_ENDPOINT", "AWS_ACCESS_KEY_ID",
                     "AWS_SECRET_ACCESS_KEY"):
            os.environ.pop(name, None)
        port, jax = ts3.s3_store_from_settings_and_env(), \
            js3.s3_store_from_settings_and_env()
    assert port.endpoint == jax.endpoint == "https://s3.ap-south-1.amazonaws.com"
    assert port.credentials is None and jax.credentials is None
    assert Path(ts3.__file__).parent.name == "data"

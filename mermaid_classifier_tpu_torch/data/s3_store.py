"""S3-compatible ObjectStore over plain stdlib HTTP.

The port's own copy of ``mermaid_classifier_tpu/data/s3_store.py`` (that
module imports no jax, but the port imports nothing of the JAX package).
This backend speaks the S3 REST dialect directly, urllib plus a first-party
AWS Signature Version 4 signer, so the same ``ObjectStore`` interface
covers s3:// roots with no new dependency. Any S3-compatible endpoint works
(AWS, GCS interop, MinIO, or the in-process fake server of the tests,
``tests/data/fake_s3_server.py``).

Scope: the five interface operations (exists / get / put / list / delete)
with ListObjectsV2 pagination, optional anonymous access, and bounded
retries on transient failures. Multipart upload is out of scope: feature
files are a few hundred KB. There is no ``download`` of its own: the
base ``ObjectStore.download`` (get, then an atomic write) serves
``download_parallel``.
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import os
import time
import urllib.error
import urllib.parse
import urllib.request
import xml.etree.ElementTree as ET
from collections.abc import Iterator
from dataclasses import dataclass

from mermaid_classifier_tpu_torch.data.store import ObjectStore, ObjectStoreError

_EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()


@dataclass(frozen=True)
class S3Credentials:
    access_key: str
    secret_key: str
    session_token: str | None = None

    @classmethod
    def from_env(cls) -> "S3Credentials | None":
        """Standard AWS env names; None means anonymous (unsigned) access."""
        access = os.environ.get("AWS_ACCESS_KEY_ID")
        secret = os.environ.get("AWS_SECRET_ACCESS_KEY")
        if not access or not secret:
            return None
        return cls(access, secret, os.environ.get("AWS_SESSION_TOKEN"))


def _uri_encode(value: str, *, encode_slash: bool) -> str:
    # SigV4 canonical encoding: unreserved chars stay, everything else is
    # %XX uppercase; '/' is kept only inside the path.
    safe = "-._~" + ("" if encode_slash else "/")
    return urllib.parse.quote(value, safe=safe)


def _canonical_query(query: str) -> str:
    if not query:
        return ""
    pairs = []
    for part in query.split("&"):
        if not part:
            continue
        name, _, value = part.partition("=")
        pairs.append(
            (
                _uri_encode(urllib.parse.unquote(name), encode_slash=True),
                _uri_encode(urllib.parse.unquote(value), encode_slash=True),
            )
        )
    return "&".join(f"{n}={v}" for n, v in sorted(pairs))


def _hmac_sha256(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def sign_request(
    method: str,
    url: str,
    headers: dict[str, str],
    payload_hash: str,
    *,
    credentials: S3Credentials,
    region: str,
    service: str = "s3",
    now: datetime.datetime | None = None,
) -> dict[str, str]:
    """AWS Signature Version 4 (public algorithm, docs.aws.amazon.com).

    Returns the full header dict to send: the input headers plus
    ``x-amz-date``, ``x-amz-content-sha256``, optional security token, and
    ``Authorization``. Pinned against the published AWS test vector in
    tests/test_torch_s3_store.py.
    """
    parsed = urllib.parse.urlsplit(url)
    if now is None:
        now = datetime.datetime.now(datetime.timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    datestamp = now.strftime("%Y%m%d")

    all_headers = dict(headers)
    all_headers.setdefault("host", parsed.netloc)
    all_headers["x-amz-date"] = amz_date
    if service == "s3":
        all_headers["x-amz-content-sha256"] = payload_hash
    if credentials.session_token:
        all_headers["x-amz-security-token"] = credentials.session_token

    lower = {k.lower(): " ".join(str(v).split()) for k, v in all_headers.items()}
    signed_names = ";".join(sorted(lower))
    canonical_headers = "".join(f"{k}:{lower[k]}\n" for k in sorted(lower))
    canonical_request = "\n".join(
        (
            method.upper(),
            _uri_encode(urllib.parse.unquote(parsed.path or "/"), encode_slash=False),
            _canonical_query(parsed.query),
            canonical_headers,
            signed_names,
            payload_hash,
        )
    )

    scope = f"{datestamp}/{region}/{service}/aws4_request"
    string_to_sign = "\n".join(
        (
            "AWS4-HMAC-SHA256",
            amz_date,
            scope,
            hashlib.sha256(canonical_request.encode()).hexdigest(),
        )
    )

    key = _hmac_sha256(f"AWS4{credentials.secret_key}".encode(), datestamp)
    key = _hmac_sha256(key, region)
    key = _hmac_sha256(key, service)
    key = _hmac_sha256(key, "aws4_request")
    signature = hmac.new(key, string_to_sign.encode(), hashlib.sha256).hexdigest()

    all_headers["Authorization"] = (
        f"AWS4-HMAC-SHA256 Credential={credentials.access_key}/{scope},"
        f" SignedHeaders={signed_names}, Signature={signature}"
    )
    return all_headers


class S3ObjectStore(ObjectStore):
    """ObjectStore over the S3 REST API, path-style addressing.

    ``endpoint`` is the scheme+host ("https://s3.us-east-1.amazonaws.com",
    "http://127.0.0.1:9000", ...). ``credentials=None`` sends unsigned
    requests (public buckets / unauthenticated fakes).
    """

    def __init__(
        self,
        endpoint: str,
        region: str = "us-east-1",
        credentials: S3Credentials | None = None,
        *,
        max_retries: int = 3,
        retry_backoff_s: float = 0.5,
        timeout_s: float = 60.0,
    ):
        self.endpoint = endpoint.rstrip("/")
        self.region = region
        self.credentials = credentials
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        self.timeout_s = timeout_s

    # -- plumbing --------------------------------------------------------

    def _url(self, bucket: str, key: str = "", query: str = "") -> str:
        path = f"/{bucket}"
        if key:
            path += "/" + urllib.parse.quote(key, safe="/-._~")
        return self.endpoint + path + (f"?{query}" if query else "")

    def _request(
        self,
        method: str,
        url: str,
        data: bytes | None = None,
        ok_statuses: tuple[int, ...] = (200,),
        tolerate_404: bool = False,
    ) -> tuple[int, bytes]:
        payload = data or b""
        payload_hash = hashlib.sha256(payload).hexdigest() if data else _EMPTY_SHA256
        headers: dict[str, str] = {}
        if data is not None:
            headers["content-length"] = str(len(payload))
        if self.credentials is not None:
            headers = sign_request(
                method,
                url,
                headers,
                payload_hash,
                credentials=self.credentials,
                region=self.region,
            )

        last_error: Exception | None = None
        for attempt in range(self.max_retries):
            request = urllib.request.Request(
                url, data=data, headers=headers, method=method
            )
            try:
                with urllib.request.urlopen(request, timeout=self.timeout_s) as resp:
                    return resp.status, resp.read()
            except urllib.error.HTTPError as exc:
                if exc.code == 404 and tolerate_404:
                    return 404, b""
                if exc.code in ok_statuses:
                    return exc.code, exc.read() or b""
                body = exc.read()[:500]
                last_error = ObjectStoreError(
                    f"{method} {url} -> HTTP {exc.code}: {body!r}"
                )
                if exc.code < 500:  # client errors don't heal with retries
                    raise last_error from exc
            except urllib.error.URLError as exc:
                last_error = ObjectStoreError(f"{method} {url} failed: {exc}")
            if attempt + 1 < self.max_retries:
                time.sleep(self.retry_backoff_s * (2**attempt))
        assert last_error is not None
        raise last_error

    # -- interface -------------------------------------------------------

    def exists(self, bucket: str, key: str) -> bool:
        status, _ = self._request(
            "HEAD", self._url(bucket, key), tolerate_404=True
        )
        return status == 200

    def get_bytes(self, bucket: str, key: str) -> bytes:
        status, body = self._request(
            "GET", self._url(bucket, key), tolerate_404=True
        )
        if status == 404:
            raise ObjectStoreError(f"object not found: {bucket}/{key}")
        return body

    def put_bytes(self, bucket: str, key: str, data: bytes) -> None:
        self._request("PUT", self._url(bucket, key), data=data)

    def delete(self, bucket: str, key: str) -> None:
        self._request(
            "DELETE",
            self._url(bucket, key),
            ok_statuses=(200, 204),
            tolerate_404=True,
        )

    def list_keys(self, bucket: str, prefix: str = "") -> Iterator[str]:
        """ListObjectsV2 with continuation-token pagination."""
        token: str | None = None
        while True:
            query = "list-type=2"
            if prefix:
                query += "&prefix=" + urllib.parse.quote(prefix, safe="")
            if token:
                query += "&continuation-token=" + urllib.parse.quote(token, safe="")
            _, body = self._request("GET", self._url(bucket, query=query))
            root = ET.fromstring(body)
            # Namespace-agnostic tag matching (AWS stamps a doc namespace).
            def findall(parent, tag):
                return [e for e in parent.iter() if e.tag.split("}")[-1] == tag]

            for contents in findall(root, "Contents"):
                for key_el in findall(contents, "Key"):
                    yield key_el.text or ""
            truncated = next(
                (e.text for e in findall(root, "IsTruncated")), "false"
            )
            if (truncated or "false").lower() != "true":
                return
            token = next(
                (e.text for e in findall(root, "NextContinuationToken")), None
            )
            if not token:
                return


def s3_store_from_settings_and_env() -> S3ObjectStore:
    """Build an S3ObjectStore from settings/env: endpoint from
    OBJECT_STORE_ENDPOINT (or the regional AWS default), region from
    AWS_REGION, credentials from the standard AWS env names (anonymous
    when unset)."""
    region = os.environ.get("AWS_REGION", "us-east-1")
    endpoint = os.environ.get(
        "OBJECT_STORE_ENDPOINT", f"https://s3.{region}.amazonaws.com"
    )
    return S3ObjectStore(
        endpoint=endpoint, region=region, credentials=S3Credentials.from_env()
    )

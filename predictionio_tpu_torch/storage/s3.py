"""S3 model storage backend (a copy of the JAX package's ``storage/s3.py``).

Parity: storage/s3/src/main/scala/.../s3/{StorageClient,S3Models}.scala:36-95
— model blobs as objects ``<BASE_PATH>/<id>`` in a bucket, with optional
custom endpoint and region. The reference used the AWS Java SDK; this
implementation speaks the S3 REST API directly over stdlib HTTP with
AWS Signature V4 request signing (no SDK dependency), which also makes
it work against any S3-compatible store (MinIO, localstack, GCS interop
endpoint) via ``ENDPOINT``.

Config properties:
  ``BUCKET_NAME`` (required), ``BASE_PATH`` (key prefix, default ``""``),
  ``REGION`` (default ``us-east-1``), ``ENDPOINT`` (default
  ``https://s3.<region>.amazonaws.com``; path-style addressing is used so
  custom endpoints work), ``ACCESS_KEY_ID`` / ``SECRET_ACCESS_KEY``
  (fall back to ``AWS_ACCESS_KEY_ID`` / ``AWS_SECRET_ACCESS_KEY`` env),
  plus the ``RETRY_*``/``BREAKER_*`` resilience knobs
  (docs/operations-resilience.md). Every object round trip routes
  through ``resilient()``: transport failures and 5xx retry with
  jittered backoff and feed the circuit breaker; 404 and other 4xx pass
  through unchanged for the callers' not-found handling.
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import os
import urllib.error
import urllib.parse
import urllib.request

from predictionio_tpu_torch.storage import base
from predictionio_tpu_torch.storage.base import Model, StorageClientConfig
from predictionio_tpu_torch.utils.resilience import (
    Resilience,
    TransientError,
    is_transient_http_status,
    resilient,
)


class S3Error(RuntimeError):
    pass


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def _uri_encode(s: str) -> str:
    # S3 canonical URI encoding: everything except unreserved chars and "/"
    return urllib.parse.quote(s, safe="/-_.~")


def sign_v4_headers(
    method: str,
    url: str,
    region: str,
    access_key: str,
    secret_key: str,
    payload: bytes,
    now: datetime.datetime | None = None,
) -> dict[str, str]:
    """AWS Signature V4 headers for one S3 request (service ``s3``).

    Exposed as a function so tests can pin ``now`` and check against
    known-good signatures.
    """
    parts = urllib.parse.urlsplit(url)
    now = now or datetime.datetime.now(datetime.timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    datestamp = now.strftime("%Y%m%d")
    payload_hash = hashlib.sha256(payload).hexdigest()

    canonical_headers = (
        f"host:{parts.netloc}\n"
        f"x-amz-content-sha256:{payload_hash}\n"
        f"x-amz-date:{amz_date}\n"
    )
    signed_headers = "host;x-amz-content-sha256;x-amz-date"
    canonical_request = "\n".join(
        [
            method,
            _uri_encode(parts.path or "/"),
            parts.query,  # model keys produce no query strings
            canonical_headers,
            signed_headers,
            payload_hash,
        ]
    )
    scope = f"{datestamp}/{region}/s3/aws4_request"
    string_to_sign = "\n".join(
        [
            "AWS4-HMAC-SHA256",
            amz_date,
            scope,
            hashlib.sha256(canonical_request.encode()).hexdigest(),
        ]
    )
    k = _hmac(("AWS4" + secret_key).encode(), datestamp)
    k = _hmac(k, region)
    k = _hmac(k, "s3")
    k = _hmac(k, "aws4_request")
    signature = hmac.new(k, string_to_sign.encode(), hashlib.sha256).hexdigest()
    return {
        "x-amz-date": amz_date,
        "x-amz-content-sha256": payload_hash,
        "Authorization": (
            f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
            f"SignedHeaders={signed_headers}, Signature={signature}"
        ),
    }


class S3Models(base.Models):
    def __init__(
        self,
        bucket: str,
        base_path: str = "",
        region: str = "us-east-1",
        endpoint: str | None = None,
        access_key: str | None = None,
        secret_key: str | None = None,
        timeout: float = 30.0,
        resilience: Resilience | None = None,
    ):
        self._bucket = bucket
        self._base_path = base_path.strip("/")
        self._region = region
        self._endpoint = (endpoint or f"https://s3.{region}.amazonaws.com").rstrip("/")
        self._access_key = access_key or os.environ.get("AWS_ACCESS_KEY_ID", "")
        self._secret_key = secret_key or os.environ.get("AWS_SECRET_ACCESS_KEY", "")
        self._timeout = timeout
        self._resilience = resilience or Resilience("s3")

    def _url(self, model_id: str) -> str:
        safe = urllib.parse.quote(model_id, safe="")
        key = f"{self._base_path}/{safe}" if self._base_path else safe
        return f"{self._endpoint}/{self._bucket}/{key}"

    def _request(self, method: str, model_id: str, payload: bytes = b""):
        return resilient(
            self._resilience, self._raw_request, method, model_id, payload)

    def _raw_request(self, method: str, model_id: str, payload: bytes = b""):
        """One signed object round trip. Only reachable through
        ``resilient()``: transport failures and 5xx raise TransientError
        (retried under the policy); 4xx — including the 404s the callers
        map to not-found — pass through untouched."""
        url = self._url(model_id)
        headers = {}
        if self._access_key:
            headers = sign_v4_headers(
                method, url, self._region, self._access_key, self._secret_key, payload
            )
        req = urllib.request.Request(url, data=payload or None, method=method,
                                     headers=headers)
        try:
            return urllib.request.urlopen(req, timeout=self._timeout)
        except urllib.error.HTTPError as exc:
            if is_transient_http_status(exc.code):
                raise TransientError(
                    f"{method} {model_id}: HTTP {exc.code}") from exc
            raise
        except urllib.error.URLError as exc:
            raise TransientError(f"{method} {model_id}: {exc.reason}") from exc

    def insert(self, model: Model) -> None:
        with self._request("PUT", model.id, model.models) as resp:
            if resp.status not in (200, 201):
                raise S3Error(f"PUT {model.id}: HTTP {resp.status}")

    def get(self, model_id: str) -> Model | None:
        try:
            with self._request("GET", model_id) as resp:
                return Model(model_id, resp.read())
        except urllib.error.HTTPError as exc:
            if exc.code == 404:
                return None
            raise S3Error(f"GET {model_id}: HTTP {exc.code}") from exc

    def delete(self, model_id: str) -> None:
        try:
            with self._request("DELETE", model_id):
                pass
        except urllib.error.HTTPError as exc:
            if exc.code != 404:
                raise S3Error(f"DELETE {model_id}: HTTP {exc.code}") from exc


class S3StorageClient(base.BaseStorageClient):
    prefix = "S3"

    def __init__(self, config: StorageClientConfig = StorageClientConfig()):
        super().__init__(config)
        props = config.properties
        bucket = props.get("BUCKET_NAME")
        if not bucket:
            raise S3Error("s3 storage source requires a BUCKET_NAME property")
        source = props.get("SOURCE_NAME", bucket)
        self._models = S3Models(
            bucket=bucket,
            base_path=props.get("BASE_PATH", ""),
            region=props.get("REGION", "us-east-1"),
            endpoint=props.get("ENDPOINT"),
            access_key=props.get("ACCESS_KEY_ID"),
            secret_key=props.get("SECRET_ACCESS_KEY"),
            resilience=Resilience.from_properties(f"s3/{source}", props),
        )

    def models(self) -> S3Models:
        return self._models

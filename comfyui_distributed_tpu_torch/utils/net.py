"""HTTP helpers of the fan-out on the standard library: the counterparts
of ``comfyui_distributed_tpu/utils/net.py`` without ``aiohttp``.

- ``multipart/form-data``: :class:`FormData` writes what aiohttp's
  ``request.post()`` reads, and :func:`parse_multipart` reads what
  ``aiohttp.FormData`` writes (boundary, ``Content-Disposition`` with
  ``filename``, a ``Content-Type`` on each part; the wire format of an
  upload is read from its part's type).
- :func:`post_form_with_retry`: exponential backoff with jitter; retries
  404 (a queue not prepared yet), 5xx and connection errors, and honours
  ``Retry-After``; ``headers`` (the sender's ``traceparent``) ride every
  attempt.
- :func:`in_context`: a callable that runs on another thread (a pool's)
  in the caller's transfer attribution and span context, under a
  pipeline ``stage``: the counterpart of the JAX package's
  ``HostIOPool.submit`` handoff, so the data plane's encodes and copies
  stay in the job's trace and transfer ledger.
- :class:`HostIOPool`: the overlapped finalize's bounded pool, whose
  tasks run through :func:`in_context`, so a deferred encode stays in
  the job's trace.
- :func:`negotiate_wire_format` / :func:`wire_codec`: one
  ``GET /distributed/wire_formats`` per master decides between raw-tensor
  uploads and PNG.
- :func:`network_info`: this host's addresses and the one to give remote
  workers (``GET /distributed/network_info``).
"""

from __future__ import annotations

import concurrent.futures
import http.client
import json
import os
import random
import socket
import threading
import time
import urllib.error
import urllib.request
import uuid
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from comfyui_distributed_tpu_torch.utils import constants as C
from comfyui_distributed_tpu_torch.utils import trace as trace_mod

# --- multipart/form-data ----------------------------------------------------


@dataclass
class FormPart:
    name: str
    data: bytes
    filename: Optional[str] = None
    content_type: Optional[str] = None

    @property
    def text(self) -> str:
        return self.data.decode(_param(self.content_type or "",
                                       "charset") or "utf-8")


class FormData:
    """A multipart form, written as aiohttp's ``FormData`` writes it: a
    text part carries ``text/plain; charset=utf-8``, a file part its
    ``filename`` and content type."""

    def __init__(self) -> None:
        self.parts: List[FormPart] = []
        self.boundary = uuid.uuid4().hex

    def add_field(self, name: str, value, filename: Optional[str] = None,
                  content_type: Optional[str] = None) -> None:
        if isinstance(value, str):
            data = value.encode("utf-8")
            content_type = content_type or "text/plain; charset=utf-8"
        else:
            data = bytes(value)
            content_type = content_type or "application/octet-stream"
        self.parts.append(FormPart(name, data, filename, content_type))

    @property
    def content_type(self) -> str:
        return f"multipart/form-data; boundary={self.boundary}"

    def encode(self) -> bytes:
        b = self.boundary.encode()
        out = []
        for p in self.parts:
            disp = f'form-data; name="{p.name}"'
            if p.filename is not None:
                disp += f'; filename="{p.filename}"'
            out.append(b"--" + b + b"\r\n"
                       + f"Content-Type: {p.content_type}\r\n".encode()
                       + f"Content-Disposition: {disp}\r\n\r\n".encode()
                       + p.data + b"\r\n")
        out.append(b"--" + b + b"--\r\n")
        return b"".join(out)


def _param(header: str, key: str) -> Optional[str]:
    """A parameter of a header value (``multipart/form-data;
    boundary=...``, ``form-data; name="x"``); quotes removed."""
    for item in header.split(";")[1:]:
        k, sep, v = item.strip().partition("=")
        if sep and k.strip().lower() == key:
            v = v.strip()
            if len(v) >= 2 and v[0] == v[-1] == '"':
                v = v[1:-1].replace('\\"', '"').replace("\\\\", "\\")
            return v
    return None


def parse_multipart(body: bytes, content_type: str) -> Dict[str, FormPart]:
    """A ``multipart/form-data`` body -> name -> part (the first part of
    a name wins, as ``aiohttp``'s ``MultiDict.get`` returns)."""
    boundary = _param(content_type, "boundary")
    if not content_type.lower().startswith("multipart/form-data") \
            or not boundary:
        raise ValueError(f"not a multipart form: {content_type!r}")
    delim = b"\r\n--" + boundary.encode()
    chunks = (b"\r\n" + body).split(delim)
    out: Dict[str, FormPart] = {}
    for chunk in chunks[1:]:
        if chunk.startswith(b"--"):
            break
        # transport padding, then the CRLF that ends the delimiter line
        head, sep, data = chunk[chunk.index(b"\r\n") + 2:].partition(
            b"\r\n\r\n")
        if not sep:
            raise ValueError("multipart part without a header end")
        headers = {}
        for line in head.split(b"\r\n"):
            k, _, v = line.decode("latin-1").partition(":")
            headers[k.strip().lower()] = v.strip()
        disp = headers.get("content-disposition", "")
        name = _param(disp, "name")
        if name is None:
            raise ValueError(f"multipart part without a name: {disp!r}")
        out.setdefault(name, FormPart(name, data, _param(disp, "filename"),
                                      headers.get("content-type")))
    return out


# --- plain requests ----------------------------------------------------------


def get_json(url: str, timeout: float = 10.0,
             headers: Optional[Dict[str, str]] = None) -> Any:
    req = urllib.request.Request(url, headers=headers or {})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def post_json(url: str, payload: Any, timeout: float = 30.0,
              headers: Optional[Dict[str, str]] = None) -> Any:
    """POST JSON; an HTTP error status raises ``RuntimeError`` with the
    start of the body."""
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return json.loads(r.read())
    except urllib.error.HTTPError as e:
        body = e.read().decode("utf-8", "replace")
        raise RuntimeError(f"POST {url}: {e.code}: {body[:200]}") from None


def request_json(method: str, url: str, payload: Any = None,
                 timeout: float = 30.0,
                 headers: Optional[Dict[str, str]] = None
                 ) -> Tuple[int, Any, Dict[str, str]]:
    """One JSON request that keeps what an error status carries: (the
    status, the decoded body or None, the response headers).  A
    connection error raises."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(
        url, data=data, method=method,
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            status, raw, hdrs = r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        status, raw, hdrs = e.code, e.read(), dict(e.headers or {})
    try:
        body = json.loads(raw) if raw else None
    except ValueError:
        body = None
    return status, body, hdrs


def _retry_after_hint(headers) -> Optional[float]:
    raw = (headers or {}).get("Retry-After")
    if raw is None:
        return None
    try:
        return min(max(float(raw), 0.0), C.RETRY_AFTER_CAP_S)
    except (TypeError, ValueError):
        return None


def backoff_delays(retries: int, rng=None) -> List[float]:
    """The sleeps between attempts: ``min(base * 2^k, cap) *
    uniform[1 - j, 1]``, so senders that failed together do not retry
    together."""
    rng = rng or random
    out, delay = [], C.SEND_BACKOFF_BASE
    for _ in range(max(retries - 1, 0)):
        out.append(delay * rng.uniform(1.0 - C.SEND_JITTER_FRACTION, 1.0))
        delay = min(delay * 2, C.SEND_BACKOFF_CAP)
    return out


def post_form_with_retry(url: str, make_form: Callable[[], FormData],
                         timeout: float, max_retries: Optional[int] = None,
                         what: str = "upload",
                         headers: Optional[Dict[str, str]] = None) -> None:
    """POST a multipart form until the server answers 200; any other
    status (404 while the master has not prepared the job, 5xx) or a
    connection error is retried after the next backoff delay, or after a
    longer ``Retry-After`` of a 429/503.  Raises after the last try.

    The chaos harness (``utils/chaos.py``) may drop an attempt (a
    ``ChaosDropError``, retried as a transport error) or delay it: the
    client's half of a flaky network."""
    from comfyui_distributed_tpu_torch.utils import chaos as chaos_mod
    retries = max_retries if max_retries is not None else C.SEND_MAX_RETRIES
    delays = backoff_delays(retries)
    attempt_timeout = min(timeout, C.SEND_ATTEMPT_TIMEOUT_CAP)
    for attempt in range(retries):
        retry_after = None
        form = make_form()
        req = urllib.request.Request(url, data=form.encode(),
                                     headers={"Content-Type":
                                              form.content_type,
                                              **(headers or {})})
        try:
            cm = chaos_mod.get_chaos()
            if cm.active:
                extra = cm.client_edge(url, what=what)  # a drop raises
                if extra > 0:
                    time.sleep(extra)
            with urllib.request.urlopen(req, timeout=attempt_timeout) as r:
                r.read()
                return
        except urllib.error.HTTPError as e:
            if e.code in (429, 503):
                retry_after = _retry_after_hint(e.headers)
            body = e.read().decode("utf-8", "replace")
            err: Exception = RuntimeError(f"{what} {e.code}: {body[:100]}")
        except (OSError, http.client.HTTPException) as e:
            err = e
        if attempt == retries - 1:
            raise err
        time.sleep(max(delays[attempt], retry_after or 0.0))


def in_context(fn: Callable[..., Any], stage: Optional[str] = None
               ) -> Callable[..., Any]:
    """``fn`` bound to this thread's transfer attribution (node label and
    run ledgers) and span context, captured now, for a call on another
    thread; with ``stage`` each call is timed into that pipeline stage
    (and a span of its name in the trace)."""
    captured = trace_mod.capture_transfer_context()
    captured_span = trace_mod.capture_span_context()

    def run(*args, **kwargs):
        with trace_mod.transfer_context(captured), \
                trace_mod.use_span(captured_span):
            if stage:
                with trace_mod.stage(stage):
                    return fn(*args, **kwargs)
            return fn(*args, **kwargs)
    return run


# --- overlapped host-IO pool -------------------------------------------------

class HostIOPool:
    """Bounded pool of the overlapped finalize: output nodes' host work
    (the wait for a copy, PNG encodes, disk writes) runs here, so one
    job's encodes overlap the next job's kernels.  ``max_pending`` tasks
    in flight (``DTPU_HOSTIO_PENDING``), then :meth:`submit` blocks the
    producer: the card cannot outrun a slow disk by buffering images
    without bound.  ``DTPU_HOSTIO_THREADS`` threads."""

    def __init__(self, max_workers: Optional[int] = None,
                 max_pending: Optional[int] = None):
        max_workers = max_workers or int(os.environ.get(
            C.HOSTIO_THREADS_ENV, C.HOSTIO_THREADS_DEFAULT))
        max_pending = max_pending or int(os.environ.get(
            C.HOSTIO_PENDING_ENV, C.HOSTIO_PENDING_DEFAULT))
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max(1, max_workers),
            thread_name_prefix="dtpu-hostio")
        self._slots = threading.BoundedSemaphore(max(1, max_pending))
        self._pending = 0  # guarded-by: self._lock
        self._lock = threading.Lock()

    @property
    def pending(self) -> int:
        with self._lock:
            return self._pending

    def submit(self, fn: Callable[..., Any],
               *args) -> concurrent.futures.Future:
        """Schedule ``fn(*args)``; returns its future.  It runs in the
        submitting thread's transfer attribution and span context
        (:func:`in_context`)."""
        bound = in_context(fn)
        self._slots.acquire()
        with self._lock:
            self._pending += 1

        def run():
            try:
                return bound(*args)
            finally:
                with self._lock:
                    self._pending -= 1
                self._slots.release()

        return self._pool.submit(run)

    def shutdown(self, wait: bool = True) -> None:
        self._pool.shutdown(wait=wait, cancel_futures=not wait)


# --- wire-format negotiation -------------------------------------------------

# master_url -> (upload content type, tensor codec), one probe per master
_wire_formats: Dict[str, Tuple[str, str]] = {}
_wire_lock = threading.Lock()


def reset_wire_cache() -> None:
    with _wire_lock:
        _wire_formats.clear()


def wire_codec(master_url: str) -> str:
    """The tensor codec negotiated with ``master_url``; zlib when none
    was."""
    with _wire_lock:
        return _wire_formats.get(master_url, ("", "zlib"))[1]


def negotiate_wire_format(master_url: str) -> str:
    """The upload content type toward ``master_url``: the raw-tensor type
    with the best codec both sides decode when the master lists it, else
    PNG (an older master, or a network error)."""
    from comfyui_distributed_tpu_torch.utils.image import tensor_codecs
    with _wire_lock:
        cached = _wire_formats.get(master_url)
    if cached is not None:
        return cached[0]
    fmt, codec = "image/png", "zlib"
    try:
        body = get_json(f"{master_url}/distributed/wire_formats", timeout=5,
                        headers={"Accept": C.TENSOR_WIRE_CONTENT_TYPE})
        if C.TENSOR_WIRE_CONTENT_TYPE in body.get("formats", []):
            fmt = C.TENSOR_WIRE_CONTENT_TYPE
            theirs = body.get("tensor_codecs", ["zlib"])
            codec = next((c for c in tensor_codecs() if c in theirs), "zlib")
    except (OSError, ValueError, http.client.HTTPException):
        pass
    with _wire_lock:
        _wire_formats[master_url] = (fmt, codec)
    return fmt


# --- host addresses ------------------------------------------------------------

def get_network_ips() -> List[str]:
    """This host's IPv4 addresses: its name's, the source address of a
    route (a UDP socket's connect sends nothing) and 127.0.0.1."""
    ips: List[str] = []
    try:
        for info in socket.getaddrinfo(socket.gethostname(), None,
                                       family=socket.AF_INET):
            if info[4][0] not in ips:
                ips.append(info[4][0])
    except socket.gaierror:
        pass
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            s.connect(("10.255.255.255", 1))
            ip = s.getsockname()[0]
            if ip not in ips:
                ips.append(ip)
        finally:
            s.close()
    except OSError:
        pass
    if "127.0.0.1" not in ips:
        ips.append("127.0.0.1")
    return ips


def _private_rank(ip: str) -> int:
    """192.168/16 first, then 10/8, 172.16/12, any other, loopback."""
    if ip.startswith("192.168."):
        return 0
    if ip.startswith("10."):
        return 1
    if ip.startswith("172."):
        try:
            if 16 <= int(ip.split(".")[1]) <= 31:
                return 2
        except (IndexError, ValueError):
            pass
    if ip.startswith("127."):
        return 9
    return 5


def get_recommended_ip() -> str:
    return sorted(get_network_ips(), key=_private_rank)[0]


def network_info() -> Dict[str, Any]:
    """``GET /distributed/network_info``: the addresses, the one a
    remote worker should use, the host name."""
    return {"ips": get_network_ips(), "recommended_ip": get_recommended_ip(),
            "hostname": socket.gethostname()}


def find_free_port(host: str = "127.0.0.1") -> int:
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.bind((host, 0))
    port = s.getsockname()[1]
    s.close()
    return port

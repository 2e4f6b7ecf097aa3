"""Cross-request reuse plane: the counterpart of
``comfyui_distributed_tpu/runtime/reuse.py``, with the same keys, tiers,
counters and budgets.

Serving traffic repeats itself: retries, seed variants of one prompt,
re-upscales of a mostly unchanged image.  Three content-addressed tiers
skip the repeated work:

- **exact-hit results** (:attr:`ReusePlane.result`): key = the graph's
  full node and widget structure, seed included (:func:`result_key`);
  a byte-identical re-submission replays the stored images from host
  memory, and the server marks its history entry and span
  ``cache_hit``;
- **encode memo** (:attr:`ReusePlane.subgraph`): text-encoder
  conditionings and VAE-encoded latents kept on the device, keyed by a
  content hash of their input sub-graph (:func:`subgraph_keys`), so a
  storm of variants pays each encode once;
- **changed-tile skipping** (:attr:`ReusePlane.tiles`): per-tile content
  hashes in the tiled upscale (:func:`tile_keys`); a re-run of a mostly
  unchanged image refines only the tiles whose pixels moved, and the
  blend takes the stored windows of the others.

Each tier is an LRU bounded by its own byte budget (``DTPU_CACHE_*``);
the resource monitor samples their total as ``cache_bytes``, and
``DTPU_CACHE=0`` turns them all off before any key is computed.

:class:`PreviewBus` is the preview and cancellation channel of ``GET
/distributed/preview/<prompt_id>``: it fans events out to subscribers,
and a prompt whose last subscriber disconnects while it is queued is
marked abandoned, so the server purges it before it runs.

The keys equal the JAX package's string for string on the same graph
(``hash_array`` reads torch tensors as the numpy arrays the JAX package
hashes: the same bytes and the same dtype string, bf16 as ``<V2``),
except the tile keys, which carry a process-local pipeline identity
(:meth:`ReusePlane.model_salt`).
"""

from __future__ import annotations

import base64
import hashlib
import itertools
import json
import os
import queue as queue_mod
import threading
import time
import weakref
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from comfyui_distributed_tpu_torch.utils import constants as C
from comfyui_distributed_tpu_torch.utils import trace as trace_mod
from comfyui_distributed_tpu_torch.utils.log import debug_log


class AbandonedError(RuntimeError):
    """The prompt's last preview client disconnected before it ran: it is
    finalized ``abandoned`` instead of executed."""


# --- kill switches -----------------------------------------------------------

def reuse_enabled() -> bool:
    """``DTPU_CACHE=0`` turns every tier off; the hot paths check this
    before they compute a key or touch a cache."""
    return os.environ.get(C.CACHE_ENV, "1").lower() \
        not in ("0", "false", "off")


def previews_enabled() -> bool:
    return os.environ.get(C.PREVIEW_ENV, "1").lower() \
        not in ("0", "false", "off")


def _env_int(env: str, default: int) -> int:
    try:
        return int(os.environ.get(env, default))
    except (TypeError, ValueError):
        return int(default)


# --- content keys ------------------------------------------------------------

def _sha(blob: str) -> str:
    return hashlib.sha256(blob.encode()).hexdigest()


def host_array(x: Any) -> np.ndarray:
    """An array-like as a host numpy array (a torch tensor is copied to
    the host; bf16, which numpy lacks, as float32)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return np.asarray(x)


def hash_array(arr: Any) -> str:
    """Content hash of an array-like: its bytes, shape and dtype string
    (a device tensor is copied to the host here).  A bf16 tensor hashes
    its raw 2-byte words under ``<V2``, the string of the JAX package's
    bf16 arrays."""
    if isinstance(arr, torch.Tensor) and arr.dtype == torch.bfloat16:
        a = arr.detach().contiguous().cpu().view(torch.int16).numpy()
        dstr = "<V2"
    else:
        a = np.ascontiguousarray(host_array(arr))
        dstr = a.dtype.str
    return hashlib.sha1(
        a.tobytes() + str((a.shape, dstr)).encode()).hexdigest()


def result_key(prompt: Dict[str, Any],
               input_dir: Optional[str] = None,
               models_dir: Optional[str] = None,
               scope: Optional[str] = None) -> Optional[str]:
    """Exact-hit key: the canonical full node and widget structure (seed
    included) over ``RESULT_CACHE_SAFE_NODE_TYPES``, with salts for the
    state outside the graph (LoadImage's file stat, the serving dirs,
    and on a sharded master ``scope``, its shard and log epoch, so no
    shard replays another's entries and a deposed epoch's go cold).
    One changed widget gives another key.  None: not cacheable (a
    distributed node, hidden inputs, an unsafe type, no sampler)."""
    nodes: Dict[str, Any] = {}
    salts: List[str] = [f"dirs:{input_dir or ''}:{models_dir or ''}"]
    if scope:
        salts.append(f"scope:{scope}")
    has_sampler = False
    for nid, node in prompt.items():
        if not isinstance(node, dict) or "class_type" not in node:
            continue  # metadata keys ride along untouched
        ct = node.get("class_type")
        if ct not in C.RESULT_CACHE_SAFE_NODE_TYPES:
            return None
        if node.get("hidden"):
            return None
        has_sampler |= ct in ("KSampler", "KSamplerAdvanced")
        if ct == "LoadImage":
            # a re-upload under the same name must miss
            name = str(node.get("inputs", {}).get("image", ""))
            path = os.path.join(input_dir or "input", name)
            try:
                st = os.stat(path)
                salts.append(
                    f"{nid}:file:{name}:{st.st_mtime_ns}:{st.st_size}")
            except OSError:
                salts.append(f"{nid}:file:{name}:absent")
        nodes[str(nid)] = {"class_type": ct,
                           "inputs": node.get("inputs", {})}
    if not nodes or not has_sampler:
        return None
    try:
        blob = json.dumps(nodes, sort_keys=True, default=str)
    except (TypeError, ValueError):
        return None
    return _sha(blob + "|" + "|".join(sorted(salts)))


_LOADER_TYPES = ("CheckpointLoaderSimple", "LoraLoader",
                 "LoraLoaderModelOnly")


def _node_salt(node: Any, input_dir: Optional[str],
               models_dir: Optional[str]) -> Optional[str]:
    """Key material for nodes whose output depends on state outside the
    graph: LoadImage's file stat, a loader's models dir."""
    if node.class_type == "LoadImage":
        name = str(node.inputs.get("image", ""))
        path = os.path.join(input_dir or "input", name)
        try:
            st = os.stat(path)
            return f"file:{name}:{st.st_mtime_ns}:{st.st_size}"
        except OSError:
            return f"file:{name}:absent"
    if node.class_type in _LOADER_TYPES:
        return f"mdir:{models_dir or ''}"
    return ""


def subgraph_keys(graph: Any, hidden: Dict[str, Dict[str, Any]],
                  input_dir: Optional[str] = None,
                  models_dir: Optional[str] = None) -> Dict[str, str]:
    """Per-node content hash of each node's input sub-graph: its type,
    widget values and the keys of its upstream producers, in topological
    order.  Only nodes whose whole subtree is in
    ``REUSE_KEY_NODE_TYPES`` get a key; nodes with hidden inputs or
    per-run hidden overrides get none."""
    keys: Dict[str, str] = {}
    for nid in graph.topo_order():
        node = graph.nodes[nid]
        if node.class_type not in C.REUSE_KEY_NODE_TYPES:
            continue
        if node.hidden or hidden.get(nid):
            continue
        salt = _node_salt(node, input_dir, models_dir)
        if salt is None:
            continue
        parts: List[str] = [node.class_type, salt]
        ok = True
        for name in sorted(node.inputs):
            if name == "__widgets__":
                continue
            value = node.inputs[name]
            if isinstance(value, (list, tuple)) and len(value) == 2 \
                    and not isinstance(value[0], (list, dict)) \
                    and isinstance(value[1], int) \
                    and str(value[0]) in graph.nodes:
                up = keys.get(str(value[0]))
                if up is None:
                    ok = False
                    break
                parts.append(f"{name}<-{up}:{value[1]}")
            else:
                try:
                    parts.append(
                        f"{name}={json.dumps(value, sort_keys=True, default=str)}")
                except (TypeError, ValueError):
                    ok = False
                    break
        if ok:
            keys[nid] = _sha("|".join(parts))
    return keys


# --- the bounded LRU ---------------------------------------------------------

class ByteLRU:
    """Thread-safe LRU keyed by content hash, bounded by a byte budget
    and an entry cap.  Values are opaque (host numpy for the result
    tier, device tensors for the encode and tile tiers, freed when their
    entry drops).  Each decision bumps the tier's counters and the
    process-wide ``cache_<tier>_{hits,misses,evictions}``."""

    def __init__(self, name: str, max_bytes: int, max_entries: int):
        self.name = str(name)
        self.max_bytes = max(int(max_bytes), 0)
        self.max_entries = max(int(max_entries), 1)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, Tuple[Any, int]]" = \
            OrderedDict()                      # guarded-by: self._lock
        self._bytes = 0                        # guarded-by: self._lock
        self.hits = 0                          # guarded-by: self._lock
        self.misses = 0                        # guarded-by: self._lock
        self.stores = 0                        # guarded-by: self._lock
        self.evictions = 0                     # guarded-by: self._lock

    def get(self, key: str) -> Optional[Any]:
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                self.misses += 1
                trace_mod.GLOBAL_COUNTERS.bump(f"cache_{self.name}_misses")
                return None
            self._entries.move_to_end(key)
            self.hits += 1
        trace_mod.GLOBAL_COUNTERS.bump(f"cache_{self.name}_hits")
        return ent[0]

    def put(self, key: str, value: Any, nbytes: int) -> bool:
        """Insert (nothing when the one value exceeds the whole budget:
        it would only evict everything else)."""
        nbytes = max(int(nbytes), 0)
        if self.max_bytes and nbytes > self.max_bytes:
            return False
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            self._entries[key] = (value, nbytes)
            self._bytes += nbytes
            self.stores += 1
            while len(self._entries) > self.max_entries or \
                    (self.max_bytes and self._bytes > self.max_bytes
                     and len(self._entries) > 1):
                _, (_, nb) = self._entries.popitem(last=False)
                self._bytes -= nb
                self.evictions += 1
                trace_mod.GLOBAL_COUNTERS.bump(
                    f"cache_{self.name}_evictions")
        return True

    def clear(self) -> int:
        """Drop everything; returns the freed bytes."""
        with self._lock:
            freed = self._bytes
            self._entries.clear()
            self._bytes = 0
        return freed

    @property
    def bytes(self) -> int:
        with self._lock:
            return self._bytes

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def keys(self) -> List[str]:
        with self._lock:
            return list(self._entries)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"entries": len(self._entries), "bytes": self._bytes,
                    "max_bytes": self.max_bytes,
                    "max_entries": self.max_entries,
                    "hits": self.hits, "misses": self.misses,
                    "stores": self.stores, "evictions": self.evictions}


# --- the plane ---------------------------------------------------------------

class ReusePlane:
    """The three tiers and the clear generation.  Budgets come from the
    environment at construction, so tests pin them per instance."""

    def __init__(self,
                 result_bytes: Optional[int] = None,
                 device_bytes: Optional[int] = None,
                 tile_bytes: Optional[int] = None,
                 max_entries: Optional[int] = None):
        entries = max_entries if max_entries is not None else \
            _env_int(C.CACHE_ENTRIES_ENV, C.CACHE_ENTRIES_DEFAULT)
        self.result = ByteLRU(
            "result",
            result_bytes if result_bytes is not None
            else _env_int(C.CACHE_BYTES_ENV, C.CACHE_BYTES_DEFAULT),
            entries)
        self.subgraph = ByteLRU(
            "embed",
            device_bytes if device_bytes is not None
            else _env_int(C.CACHE_DEVICE_BYTES_ENV,
                          C.CACHE_DEVICE_BYTES_DEFAULT),
            entries)
        self.tiles = ByteLRU(
            "tile",
            tile_bytes if tile_bytes is not None
            else _env_int(C.CACHE_TILE_BYTES_ENV,
                          C.CACHE_TILE_BYTES_DEFAULT),
            entries)
        # bumped on clear and folded into the pipeline identities, so a
        # pipeline loaded after a clear never meets an old entry
        self._generation = 0
        # a token per live pipeline object, never reused when the object
        # dies (an id() could be recycled for another model)
        self._salt_lock = threading.Lock()
        self._model_ids: "weakref.WeakKeyDictionary" = \
            weakref.WeakKeyDictionary()     # guarded-by: self._salt_lock
        self._model_next = itertools.count()  # guarded-by: self._salt_lock

    def bytes_total(self) -> int:
        return self.result.bytes + self.subgraph.bytes + self.tiles.bytes

    def clear(self) -> int:
        """Empty every tier (``/distributed/clear_memory``); returns the
        freed bytes."""
        freed = self.result.clear() + self.subgraph.clear() \
            + self.tiles.clear()
        self._generation += 1
        return freed

    def model_salt(self, pipe: Any) -> Optional[str]:
        """Process-local identity of a loaded pipeline: its token and the
        clear generation.  None when the object cannot be weakly
        referenced (the caller then skips the tier)."""
        try:
            with self._salt_lock:
                tok = self._model_ids.get(pipe)
                if tok is None:
                    tok = next(self._model_next)
                    self._model_ids[pipe] = tok
        except TypeError:
            return None
        return f"m{tok}g{self._generation}"

    def snapshot(self) -> Dict[str, Any]:
        return {
            "enabled": reuse_enabled(),
            "bytes_total": self.bytes_total(),
            "generation": self._generation,
            "result": self.result.snapshot(),
            "embed": self.subgraph.snapshot(),
            "tile": self.tiles.snapshot(),
        }


_PLANE: Optional[ReusePlane] = None
_plane_lock = threading.Lock()


def get_reuse() -> ReusePlane:
    """The process-wide plane (caches are facts of the process, not of
    one server state)."""
    global _PLANE
    with _plane_lock:
        if _PLANE is None:
            _PLANE = ReusePlane()
        return _PLANE


def reset_reuse() -> ReusePlane:
    """A new plane, so budgets pinned in the environment take effect."""
    global _PLANE
    with _plane_lock:
        _PLANE = ReusePlane()
        return _PLANE


def cache_bytes_total() -> int:
    """Bytes cached over all tiers: the resource monitor's
    ``cache_bytes`` (0 before any plane exists; sampling makes none)."""
    plane = _PLANE
    return plane.bytes_total() if plane is not None else 0


# --- preview / client-gone cancellation channel ------------------------------

# a fixed linear map from the 4 SD latent channels to RGB: a preview
# with no VAE decode
_LATENT_RGB = np.asarray([[0.298, 0.207, 0.208],
                          [0.187, 0.286, 0.173],
                          [-0.158, 0.189, 0.264],
                          [-0.184, -0.271, -0.473]], np.float32)


def latent_preview_png(latent: Any) -> bytes:
    """One latent sample -> small PNG bytes."""
    from comfyui_distributed_tpu_torch.utils.image import encode_png
    lat = np.asarray(host_array(latent), np.float32)
    if lat.ndim == 4:
        lat = lat[0]
    ch = lat.shape[-1]
    if ch >= 4:
        rgb = lat[..., :4] @ _LATENT_RGB
    else:
        rgb = np.repeat(lat[..., :1], 3, axis=-1)
    rgb = np.clip(rgb / 6.0 + 0.5, 0.0, 1.0)
    return encode_png(rgb[None])


class PreviewBus:
    """Per-prompt event fan-out and the abandonment registry.

    A route handler :meth:`subscribe`\\ s a bounded queue; a publisher
    asks :meth:`wants` (one lookup while nobody watches) and
    :meth:`publish_latent` only for watched prompts.  A handler whose
    client disconnects calls :meth:`abandon`; the server's queue purge
    consumes the flag and finalizes the prompt ``abandoned``."""

    def __init__(self, max_clients: Optional[int] = None):
        # None: DTPU_PREVIEW_MAX_CLIENTS read on each call (the bus is
        # made at import); tests pin a number
        self._max_clients = max_clients
        self._lock = threading.Lock()
        self._subs: Dict[str, List[queue_mod.Queue]] = {}  # guarded-by: self._lock
        self._abandoned: set = set()                       # guarded-by: self._lock

    @property
    def max_clients(self) -> int:
        return self._max_clients if self._max_clients is not None else \
            _env_int(C.PREVIEW_MAX_CLIENTS_ENV,
                     C.PREVIEW_MAX_CLIENTS_DEFAULT)

    def subscribe(self, pid: str) -> Optional[queue_mod.Queue]:
        """A bounded event queue for one client, or None at the client
        cap (the route then answers 429)."""
        q: queue_mod.Queue = queue_mod.Queue(maxsize=16)
        with self._lock:
            if sum(len(v) for v in self._subs.values()) \
                    >= self.max_clients:
                return None
            self._subs.setdefault(str(pid), []).append(q)
        trace_mod.GLOBAL_COUNTERS.bump("preview_clients")
        return q

    def unsubscribe(self, pid: str, q: queue_mod.Queue) -> int:
        """Detach; returns how many subscribers remain for the prompt."""
        with self._lock:
            subs = self._subs.get(str(pid), [])
            if q in subs:
                subs.remove(q)
            n = len(subs)
            if not subs:
                self._subs.pop(str(pid), None)
        return n

    def wants(self, pid: str) -> bool:
        with self._lock:
            return str(pid) in self._subs

    def client_count(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._subs.values())

    def _fan_out(self, pid: str, event: Dict[str, Any]) -> None:
        with self._lock:
            subs = list(self._subs.get(str(pid), ()))
        for q in subs:
            try:
                q.put_nowait(event)
            except queue_mod.Full:
                # a slow client drops frames; the publisher never waits
                trace_mod.GLOBAL_COUNTERS.bump("preview_drops")

    def publish_latent(self, pid: str, step: int, total: int,
                       latent: Any) -> None:
        """Encode and fan out one step's preview (only after
        :meth:`wants` said someone watches)."""
        try:
            png = latent_preview_png(latent)
        except Exception as e:  # noqa: BLE001 - a preview never kills a step
            debug_log(f"preview encode failed for {pid}: {e}")
            return
        trace_mod.GLOBAL_COUNTERS.bump("preview_events")
        self._fan_out(str(pid), {
            "type": "preview", "prompt_id": str(pid),
            "step": int(step), "total_steps": int(total),
            "png_b64": base64.b64encode(png).decode()})

    def finish(self, pid: str, status: str) -> None:
        """The terminal event to the remaining clients; the abandonment
        flag is cleared (the prompt is settled either way)."""
        self._fan_out(str(pid), {"type": "done", "prompt_id": str(pid),
                                 "status": str(status)})
        with self._lock:
            self._abandoned.discard(str(pid))

    def abandon(self, pid: str) -> None:
        with self._lock:
            if str(pid) in self._abandoned:
                return
            self._abandoned.add(str(pid))
        trace_mod.GLOBAL_COUNTERS.bump("jobs_abandoned")

    def clear_abandoned(self, pid: str) -> None:
        """Drop a flag set for a prompt that settled between the
        disconnect handler's liveness check and its :meth:`abandon`."""
        with self._lock:
            self._abandoned.discard(str(pid))

    def is_abandoned(self, pid: str) -> bool:
        with self._lock:
            return str(pid) in self._abandoned

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "enabled": previews_enabled(),
                "clients": sum(len(v) for v in self._subs.values()),
                "watched_prompts": len(self._subs),
                "abandoned_pending": len(self._abandoned),
                "max_clients": self.max_clients,
            }


PREVIEWS = PreviewBus()


def preview_every() -> int:
    """Publish a preview every N steps (``DTPU_PREVIEW_EVERY``, >= 1)."""
    return max(_env_int(C.PREVIEW_EVERY_ENV, C.PREVIEW_EVERY_DEFAULT), 1)


# --- tile-tier helpers -------------------------------------------------------

def conditioning_fingerprint(positive: Any, negative: Any) -> str:
    """Content identity of a (positive, negative) conditioning pair: a
    refined tile depends on the embeddings, not only on the widgets."""
    parts = []
    for cond in (positive, negative):
        parts.append(hash_array(cond.context))
        pooled = getattr(cond, "pooled", None)
        parts.append(hash_array(pooled) if pooled is not None else "-")
        sc = getattr(cond, "size_cond", None)
        parts.append(str(tuple(sc)) if sc is not None else "-")
    return _sha("|".join(parts))


def tile_keys(model_salt: str, cond_fp: str, params: Dict[str, Any],
              tiles: Any, tile_indices: List[int]) -> List[str]:
    """Per-tile keys: pipeline identity, conditioning fingerprint,
    refine parameters, the tile's index (its seed is ``seed + idx``) and
    the extracted window's float32 bytes."""
    base = _sha(model_salt + "|" + cond_fp + "|"
                + json.dumps(params, sort_keys=True, default=str))
    out = []
    arr = np.ascontiguousarray(np.asarray(host_array(tiles), np.float32))
    for k, idx in enumerate(tile_indices):
        h = hashlib.sha1(arr[k].tobytes())
        h.update(f"|{base}|{int(idx)}".encode())
        out.append(h.hexdigest())
    return out


def nbytes_of(x: Any) -> int:
    """Byte size without a copy to the host: a torch tensor's storage of
    its elements, an array's ``nbytes``."""
    if isinstance(x, torch.Tensor):
        return int(x.nelement() * x.element_size())
    nb = getattr(x, "nbytes", None)
    return int(nb) if nb is not None else int(np.asarray(x).nbytes)


def tile_nbytes(window: Any) -> int:
    return nbytes_of(window)


def images_nbytes(images: List[Any]) -> int:
    return int(sum(nbytes_of(im) for im in images))


def store_result(key: str, images: List[Any], duration_s: float) -> bool:
    """The finalize path's store: a prompt's images and replay data."""
    plane = get_reuse()
    entry = {"images": [np.asarray(host_array(im)) for im in images],
             "duration_s": float(duration_s),
             "stored_at": time.time()}
    return plane.result.put(key, entry, images_nbytes(images))


def conditioning_nbytes(cond: Any) -> int:
    """Bytes of a memoised conditioning: its context and, on SDXL, its
    pooled vector."""
    n = nbytes_of(cond.context)
    pooled = getattr(cond, "pooled", None)
    if pooled is not None:
        n += nbytes_of(pooled)
    return n

"""Sharded masters: the counterpart of
``comfyui_distributed_tpu/runtime/shard.py``, on threads and the standard
library's ``ThreadingHTTPServer``.

N active masters share the prompt-id space, so no one process
serialises every admission, log append and drain:

- :class:`HashRing`: consistent hashing with virtual nodes over the
  prompt ids.  Placement is deterministic, and when a member joins or
  leaves only ~1/N of the keys move.  The same key lands on the same
  member as in the JAX package (the same SHA-1 points).
- :class:`ShardManager`: one per master (``DTPU_SHARD_ID`` and
  ``DTPU_SHARD_PEERS``).  It keeps this master's ring view, gossips it
  to the peers (``POST /distributed/ring/gossip``; the view is served at
  ``GET /distributed/ring``), watches each peer shard's master lease
  under the shared ``DTPU_SHARD_WAL_ROOT`` and, when a peer's lease
  expires and this master is the dead shard's ring successor, absorbs
  the shard: it takes the shard's lease one epoch up (fencing a zombie),
  replays its log, merges its recovered jobs, idempotency keys and
  spilled units, queues its in-flight prompts again under their ids,
  drops the member from the ring and gossips the new ring.  Every master
  is a warm takeover target; there is no standby.
- :class:`RouterState` and :func:`make_router_server`: the stateless
  admission router (``cli router``).  It hashes each ``/prompt`` to its
  owning shard and relays the answer, ``Retry-After`` included; its one
  piece of state is a cached ring it pulls again when stale.

A master that gets a prompt id another shard owns forwards it one hop,
marked with ``SHARD_FORWARD_HEADER`` (``server/app.py``), so the owner's
log holds the admission before the client has the id.

``peer_queue_depth``, ``live_peer_masters`` and
``is_autoscale_actuator`` are the autoscaler's readers and have no
caller until it is ported; the router's ``/distributed/fleet`` waits
with it.
"""

from __future__ import annotations

import bisect
import concurrent.futures
import hashlib
import itertools
import json
import os
import threading
import time
import traceback
import urllib.parse
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

from comfyui_distributed_tpu_torch.utils import clock as clock_mod
from comfyui_distributed_tpu_torch.utils import constants as C
from comfyui_distributed_tpu_torch.utils import trace as trace_mod
from comfyui_distributed_tpu_torch.utils.log import debug_log, log
from comfyui_distributed_tpu_torch.utils.net import post_json, request_json


def _hash64(key: str) -> int:
    return int.from_bytes(
        hashlib.sha1(key.encode("utf-8")).digest()[:8], "big")


class HashRing:
    """Consistent-hash ring with virtual nodes.  Immutable after
    construction (membership changes build a new ring), so reads are
    lock-free for the owner-lookup hot path."""

    def __init__(self, members: Dict[str, Any], vnodes: int = None):
        if vnodes is None:
            try:
                vnodes = int(os.environ.get(C.SHARD_VNODES_ENV,
                                            C.SHARD_VNODES_DEFAULT))
            except ValueError:
                vnodes = C.SHARD_VNODES_DEFAULT
        self.vnodes = max(int(vnodes), 1)
        self.members = sorted(str(m) for m in members)
        points: List[tuple] = []
        for m in self.members:
            for v in range(self.vnodes):
                points.append((_hash64(f"{m}#{v}"), m))
        points.sort()
        self._hashes = [h for h, _ in points]
        self._owners = [m for _, m in points]

    def owner(self, key: str) -> Optional[str]:
        """The member owning ``key``: first virtual node clockwise from
        the key's hash (wrapping)."""
        if not self._owners:
            return None
        i = bisect.bisect_right(self._hashes, _hash64(str(key)))
        return self._owners[i % len(self._owners)]

    def successor(self, member: str) -> Optional[str]:
        """Deterministic takeover target for a dead ``member``: the
        owner of the member's own id on the ring WITHOUT it.  Every
        surviving peer computes the same answer from the same live
        view, so exactly one absorbs (the flock'd lease acquire breaks
        any residual race safely)."""
        rest = [m for m in self.members if m != str(member)]
        if not rest:
            return None
        return HashRing({m: None for m in rest}, self.vnodes).owner(
            str(member))


def parse_peers(raw: str) -> Dict[str, str]:
    """``"m0=http://h:p,m1=http://h:p"`` -> ``{id: url}``."""
    out: Dict[str, str] = {}
    for part in (raw or "").split(","):
        part = part.strip()
        if not part or "=" not in part:
            continue
        sid, _, url = part.partition("=")
        if sid.strip() and url.strip():
            out[sid.strip()] = url.strip().rstrip("/")
    return out


def shard_config() -> Optional[Dict[str, Any]]:
    """The sharding arm switch: None unless ``DTPU_SHARD_ID`` is set.
    Resolved once per ServerState construction (before the durability
    plane attaches, so the per-shard WAL dir can be derived)."""
    sid = os.environ.get(C.SHARD_ID_ENV, "").strip()
    if not sid:
        return None
    members = parse_peers(os.environ.get(C.SHARD_PEERS_ENV, ""))
    members.setdefault(sid, "")
    root = os.environ.get(C.SHARD_WAL_ROOT_ENV, "").strip()
    return {
        "id": sid,
        "members": members,
        "wal_root": os.path.expanduser(root) if root else None,
    }


def _env_float(env: str, default: float) -> float:
    try:
        return float(os.environ.get(env, default))
    except ValueError:
        return default


class ShardManager:
    """One active master's membership in the multi-master ring: ring
    state + gossip + peer-lease watch + dead-shard absorption."""

    def __init__(self, state, shard_id: str, members: Dict[str, str],
                 wal_root: Optional[str] = None,
                 vnodes: Optional[int] = None,
                 gossip_s: Optional[float] = None,
                 start_threads: bool = True,
                 clock: Optional[Any] = None):
        # the clock of the peers' gossip ages and the takeover times
        self._clock = clock if clock is not None else clock_mod.WALL
        self.id = str(shard_id)
        self.wal_root = wal_root
        self._state = state
        self.gossip_s = _env_float(C.SHARD_GOSSIP_ENV,
                                   C.SHARD_GOSSIP_DEFAULT) \
            if gossip_s is None else float(gossip_s)
        self.peer_down_s = _env_float(C.SHARD_PEER_DOWN_ENV,
                                      C.SHARD_PEER_DOWN_DEFAULT)
        self.takeover_enabled = os.environ.get(
            C.SHARD_TAKEOVER_ENV, "1").lower() not in ("0", "false",
                                                       "off")
        self._vnodes = vnodes
        self._lock = threading.Lock()
        # ring membership + epoch: mutated by gossip merges (handler
        # thread) and absorb (watcher thread), read by every /prompt —
        # the lockset rule holds every access to the annotations
        self._members: Dict[str, str] = {           # guarded-by: self._lock
            str(k): str(v or "") for k, v in members.items()}
        self._ring = HashRing(self._members, vnodes)  # guarded-by: self._lock
        self._ring_epoch = 1                        # guarded-by: self._lock
        self._peer_seen: Dict[str, float] = {}      # guarded-by: self._lock
        self._peer_queue: Dict[str, int] = {}       # guarded-by: self._lock
        self._absorbed: Dict[str, Dict] = {}        # guarded-by: self._lock
        self._absorbing: set = set()                # guarded-by: self._lock
        # absorbed prompts whose takeover re-enqueue failed (full queue
        # mid-overload): {dead_shard: {pid: wal prompt record}}.  They
        # stay durably open in the dead shard's WAL — whose lease this
        # survivor keeps holding — until the gossip loop's retry lands
        # them (retry_absorbed_reenqueues); without the retry they'd be
        # lost forever, since the dead member leaves every ring and its
        # restart is fenced out by design.
        self._pending_reenqueue: Dict[str, Dict] = {}  # guarded-by: self._lock
        # a peer's higher-epoch ring that EXCLUDES us means we were
        # absorbed while dead/partitioned: this master must stop
        # acting like an owner (no further takeovers) and say so
        self.deposed = False
        self.takeovers = 0
        self.forwards = 0
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        if start_threads:
            self.start()

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> None:
        if self._threads:
            return
        t = threading.Thread(target=self._gossip_loop, daemon=True,
                             name=f"dtpu-shard-gossip-{self.id}")
        t.start()
        self._threads.append(t)
        if self.wal_root:
            w = threading.Thread(target=self._watch_loop, daemon=True,
                                 name=f"dtpu-shard-watch-{self.id}")
            w.start()
            self._threads.append(w)

    def stop(self) -> None:
        self._stop.set()

    # -- ring reads -----------------------------------------------------------

    def owner_of(self, key: str) -> str:
        """Owning shard for a prompt-id; absorbed shards' keys resolve
        to their absorber because the member left the ring."""
        with self._lock:
            return self._ring.owner(str(key)) or self.id

    def is_mine(self, key: str) -> bool:
        return self.owner_of(key) == self.id

    def member_url(self, shard_id: str) -> Optional[str]:
        with self._lock:
            return self._members.get(str(shard_id)) or None

    def ring_epoch(self) -> int:
        with self._lock:
            return self._ring_epoch

    def n_members(self) -> int:
        with self._lock:
            return max(len(self._members), 1)

    def owned_shards(self) -> List[str]:
        with self._lock:
            return [self.id] + sorted(self._absorbed)

    def local_pid(self, counter: "itertools.count") -> str:
        """Generate a prompt id THIS shard owns (bounded rejection
        sampling over a disambiguating suffix), so a directly-submitted
        prompt with no router hint never needs a forward hop."""
        base = f"p_{int(self._clock.time() * 1000)}_{next(counter)}"
        if self.is_mine(base):
            return base
        for k in range(256):
            pid = f"{base}s{k}"
            if self.is_mine(pid):
                return pid
        return base  # pathological ring: accept locally anyway

    # -- gossip ---------------------------------------------------------------

    def _gossip_payload(self) -> Dict[str, Any]:
        # the queue depth is read before the ring lock is taken: it
        # takes the server's queue lock, and holding both here would
        # order them against the admission path, which takes the queue
        # lock and then reads the ring
        st = self._state
        queue_remaining = st.queue_remaining() if st is not None else 0
        with self._lock:
            return {
                "from": self.id,
                "ring_epoch": self._ring_epoch,
                "members": dict(self._members),
                "queue_remaining": queue_remaining,
            }

    def merge_gossip(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        """Apply a peer's gossiped view; returns our own (pull+push —
        one exchange converges both sides).  A strictly higher ring
        epoch replaces our membership; at equal epochs each side keeps
        its own (they started identical and only absorb bumps them)."""
        peer = str(payload.get("from", ""))
        now = self._clock.monotonic()
        changed = None
        with self._lock:
            if peer and peer != self.id:
                self._peer_seen[peer] = now
                try:
                    self._peer_queue[peer] = int(
                        payload.get("queue_remaining", 0) or 0)
                except (TypeError, ValueError):
                    pass
            their_epoch = int(payload.get("ring_epoch", 0) or 0)
            members = payload.get("members")
            if isinstance(members, dict) and members:
                if their_epoch > self._ring_epoch \
                        and str(self.id) in members:
                    # never re-adopt a member WE absorbed: a peer whose
                    # higher-epoch view predates our takeover would
                    # resurrect the dead id — and dead_peer_shards
                    # skips absorbed ids, so nobody would ever remove
                    # it again (its keyspace slice routing to a dead
                    # URL forever).  If we genuinely lost that shard's
                    # lease, renew_absorbed_leases clears _absorbed and
                    # the revived member re-enters on the next round.
                    changed = {str(k): str(v or "")
                               for k, v in members.items()
                               if str(k) not in self._absorbed}
                    self._ring_epoch = their_epoch
                elif their_epoch > self._ring_epoch and not self.deposed:
                    # a higher-epoch ring WITHOUT us: a peer absorbed
                    # our shard while we were dead/partitioned — we are
                    # a zombie owner now (the WAL fence already stops
                    # our appends; this stops our takeovers and labels
                    # the snapshot)
                    self.deposed = True
                    log(f"shard {self.id}: DEPOSED — peer ring epoch "
                        f"{their_epoch} no longer includes this shard")
                elif their_epoch == self._ring_epoch \
                        and set(members) != set(self._members) \
                        and str(self.id) in members:
                    # equal-epoch divergence = two concurrent absorbs
                    # removed different dead members.  The INTERSECTION
                    # is the deterministic merge both sides converge to
                    # (every removal was a real death; nobody re-adds).
                    keep = set(members) & set(self._members)
                    if keep and keep != set(self._members):
                        changed = {k: (self._members.get(k)
                                       or str(members.get(k) or ""))
                                   for k in keep}
            if changed is not None:
                self._members = changed
                self._ring = HashRing(self._members, self._vnodes)
                # members that left the merged ring were absorbed
                # elsewhere; drop their gossip residue
                for gone in [p for p in self._peer_seen
                             if p not in self._members]:
                    self._peer_seen.pop(gone, None)
                    self._peer_queue.pop(gone, None)
        if changed is not None:
            self._rescale_admission()
        return self._gossip_payload()

    def _rescale_admission(self) -> None:
        """Re-apply the per-client rate split after any membership
        change (the N in rate/N just moved)."""
        st = self._state
        if st is None:
            return
        try:
            st.admission.set_rate_scale(1.0 / self.n_members())
        except Exception as e:  # noqa: BLE001 - advisory
            debug_log(f"shard {self.id}: rate rescale failed: {e}")

    def gossip_once(self) -> int:
        """Push our view to every peer, merging each reply."""
        payload = self._gossip_payload()
        with self._lock:
            peers = [(sid, url) for sid, url in self._members.items()
                     if sid != self.id and url]
        reached = 0
        for sid, url in peers:
            try:
                reply = post_json(f"{url}/distributed/ring/gossip", payload,
                                  timeout=3)
                if isinstance(reply, dict):
                    self.merge_gossip(reply)
                reached += 1
            except Exception as e:  # noqa: BLE001 - gossip best-effort
                debug_log(f"shard {self.id}: gossip to {sid} failed: "
                          f"{e}")
        return reached

    def _gossip_loop(self) -> None:
        while not self._stop.wait(self.gossip_s):
            try:
                self.gossip_once()
            except Exception as e:  # noqa: BLE001 - keep gossiping
                debug_log(f"shard {self.id}: gossip round failed: {e}")

    def renew_absorbed_leases(self) -> None:
        """Keep holding every absorbed shard's lease: a restart of the
        dead master must get LeaseHeldError (failing loudly at startup)
        instead of reclaiming an expired lease and replaying a shard
        whose prompts this survivor already took over."""
        from comfyui_distributed_tpu_torch.runtime import durable as dur
        if not self.wal_root:
            return
        with self._lock:
            held = {sid: rec["epoch"]
                    for sid, rec in self._absorbed.items()}
        for sid, epoch in held.items():
            lease = dur.MasterLease(os.path.join(self.wal_root, sid))
            if not lease.renew(self.id, epoch, dur.master_lease_s()):
                # superseded: another owner acquired it (e.g. the dead
                # master restarted in an expiry gap).  Stop acting as
                # this shard's owner NOW — keeping the _absorbed /
                # _pending_reenqueue records would re-drive prompts the
                # new owner is also replaying (duplicate execution)
                log(f"shard {self.id}: lost absorbed shard {sid}'s "
                    f"lease (epoch {epoch} superseded); dropping "
                    f"ownership")
                with self._lock:
                    self._absorbed.pop(sid, None)
                    self._pending_reenqueue.pop(sid, None)

    def retry_absorbed_reenqueues(self) -> int:
        """Re-drive absorbed prompts whose takeover re-enqueue failed
        (this survivor's queue was full mid-overload — exactly when
        takeovers are most likely).  Until a retry lands, the prompt
        stays durably open in the dead shard's WAL, whose lease this
        master keeps renewing, so nobody else replays it and a restart
        of the dead master still fails loudly; once enqueued it is
        closed there under the absorb epoch exactly like the
        first-pass transfers.  Returns the number landed."""
        from comfyui_distributed_tpu_torch.runtime import durable as dur
        st = self._state
        if st is None or not self.wal_root:
            return 0
        with self._lock:
            pending = {sid: dict(pids) for sid, pids
                       in self._pending_reenqueue.items() if pids}
        total = 0
        for sid, pids in pending.items():
            with self._lock:
                rec = self._absorbed.get(sid)
            if rec is None:
                continue  # shard's lease lost/superseded: not ours
            done: List[str] = []
            landed = 0
            for pid, p in pids.items():
                prompt = p.get("prompt")
                if not isinstance(prompt, dict):
                    done.append(pid)  # unreplayable record: drop it
                    continue
                try:
                    from comfyui_distributed_tpu_torch.workflow.orchestrate \
                        import register_recovery_redispatchers
                    register_recovery_redispatchers(st, prompt)
                except Exception as e:  # noqa: BLE001 - local refine
                    debug_log(f"shard retry redispatchers for {pid} "
                              f"skipped: {e}")
                try:
                    st.enqueue_prompt(
                        prompt, p.get("extra") or {},
                        client_id=p.get("client_id", "recovered"), pid=pid,
                        _recovered=True, _absorbed=True)
                except Exception as e:  # noqa: BLE001 - still full:
                    # stays pending (and durable) for the next round
                    debug_log(f"shard {self.id}: re-enqueue retry of "
                              f"{pid} still failing: {e}")
                    continue
                done.append(pid)
                landed += 1
            if not done:
                continue
            # close the now-transferred admissions in the dead shard's
            # log (under OUR absorb epoch), mirroring absorb(): a
            # fenced-out restart must never replay them
            try:
                ddir = os.path.join(self.wal_root, sid)
                closer = dur.WriteAheadLog(
                    ddir, epoch=int(rec["epoch"]),
                    lease=dur.MasterLease(ddir))
                for pid in done:
                    closer.append("exec_done", pid=str(pid),
                                  status="absorbed")
                closer.close()
            except Exception as e:  # noqa: BLE001 - the renewed lease
                # still blocks a restart while we hold it
                log(f"shard {self.id}: closing retried transfers in "
                    f"{sid}'s WAL failed: {e}")
            with self._lock:
                cur = self._pending_reenqueue.get(sid)
                if cur is not None:
                    for pid in done:
                        cur.pop(pid, None)
                    if not cur:
                        self._pending_reenqueue.pop(sid, None)
                rec2 = self._absorbed.get(sid)
                if rec2 is not None:
                    rec2["resumed_prompts"] = \
                        int(rec2.get("resumed_prompts", 0)) + landed
            if landed:
                trace_mod.GLOBAL_COUNTERS.bump(
                    "shard_absorbed_prompts", landed)
                log(f"shard {self.id}: re-enqueued {landed} deferred "
                    f"prompt(s) from absorbed shard {sid}")
            total += landed
        return total

    # -- peer-lease watch + takeover ------------------------------------------

    def dead_peer_shards(self) -> List[str]:
        """Peer shards whose master lease EXPIRED (the holder stopped
        renewing, the signal a standby acts on).  A shard
        whose lease file never existed hasn't started; leave it be."""
        from comfyui_distributed_tpu_torch.runtime import durable as dur
        if not self.wal_root:
            return []
        with self._lock:
            peers = [sid for sid in self._members
                     if sid != self.id and sid not in self._absorbed]
        out = []
        for sid in peers:
            lease = dur.MasterLease(os.path.join(self.wal_root, sid))
            rec = lease.read()
            if rec is not None and lease.expired(rec):
                out.append(sid)
        return out

    def watch_once(self) -> List[str]:
        """One takeover scan: absorb every dead peer shard this master
        is the ring successor for.  The successor is computed on the
        ring of LIVE members only — with two simultaneous deaths, the
        plain one-member-removed successor can be the OTHER dead shard
        (and vice versa), deadlocking takeover forever; excluding every
        currently-dead member guarantees a live absorber exists, and
        all survivors still compute the same answer from the same dead
        set (the flock'd lease acquire breaks any residual race).
        Returns the shards absorbed."""
        absorbed = []
        if self.deposed:
            return absorbed  # a zombie owner must not absorb anyone
        dead = self.dead_peer_shards()
        if not dead:
            return absorbed
        with self._lock:
            live_ring = HashRing(
                {m: None for m in self._members
                 if m == self.id or m not in dead},
                self._ring.vnodes)
        for sid in dead:
            succ = live_ring.owner(sid)
            if succ != self.id or not self.takeover_enabled:
                continue
            try:
                if self.absorb(sid):
                    absorbed.append(sid)
            except Exception as e:  # noqa: BLE001 - keep watching
                log(f"shard {self.id}: takeover of {sid} failed: "
                    f"{type(e).__name__}: {e}")
        return absorbed

    def _watch_loop(self) -> None:
        from comfyui_distributed_tpu_torch.runtime import durable as dur
        interval = max(dur.master_lease_s() / C.MASTER_LEASE_FRACTION,
                       0.05)
        # absorbed-lease renewal rides THIS loop, not the gossip loop:
        # its cadence is lease/fraction by construction, and it is
        # never delayed behind gossip HTTP timeouts to dead peers —
        # with lease_s <= gossip_s an absorbed lease could otherwise
        # sit expired between renewals, letting a restarted dead
        # master reclaim it while the survivor still drives its
        # prompts (split ownership)
        while not self._stop.wait(interval):
            self.watch_once()
            try:
                self.renew_absorbed_leases()
            except Exception as e:  # noqa: BLE001
                debug_log(f"shard {self.id}: absorbed-lease renew "
                          f"failed: {e}")
            try:
                self.retry_absorbed_reenqueues()
            except Exception as e:  # noqa: BLE001
                debug_log(f"shard {self.id}: absorbed re-enqueue "
                          f"retry failed: {e}")

    def absorb(self, dead_id: str) -> Optional[Dict[str, Any]]:
        """Peer takeover of a dead shard (the multi-master analog of the
        standby's election): acquire its lease (epoch bump = the
        fencing event), replay its WAL, merge its recovered ledger
        state + idempotency keys + spilled unit payloads into THIS
        master's planes, re-enqueue its in-flight prompts under their
        ORIGINAL prompt-ids (appended to OUR WAL — the dead log goes
        dormant), re-home its workers, and remove the member from the
        ring (ring-epoch bump, gossiped immediately)."""
        from comfyui_distributed_tpu_torch.runtime import durable as dur
        dead_id = str(dead_id)
        with self._lock:
            if dead_id in self._absorbed or dead_id in self._absorbing:
                return None
            self._absorbing.add(dead_id)
        try:
            ddir = os.path.join(self.wal_root, dead_id)
            lease = dur.MasterLease(ddir)
            try:
                epoch = lease.acquire(self.id, dur.master_lease_s())
            except dur.LeaseHeldError:
                return None  # revived (or a racing peer won): back off
            replayed, info = dur.replay(ddir)
            store = dur.UnitStore(ddir)
            st = self._state
            log(f"shard {self.id}: absorbing dead shard {dead_id} "
                f"(epoch {epoch}, "
                f"{info.get('records_replayed', 0)} records, "
                f"{len(replayed.prompts)} in-flight prompt(s), "
                f"{len(replayed.jobs)} open job(s))")
            if st is not None:
                # idempotency keys BEFORE the ledger jobs: an upload
                # check-in for an absorbed job can only be accepted
                # once the job is reachable, so seeding the dead
                # shard's replayed keys first closes the window where
                # a racing retry could miss its key and double-enqueue
                st.jobs.merge_idem(replayed.idem, scope=dead_id)
                st.ledger.merge_recovered(dict(replayed.jobs), store)
                try:
                    st.health.poll_once()
                except Exception as e:  # noqa: BLE001 - best-effort
                    debug_log(f"shard absorb preflight poll: {e}")
                resumed = 0
                transferred = []
                failed_reenq: Dict[str, Dict] = {}
                for pid, p in replayed.prompts.items():
                    prompt = p.get("prompt")
                    if not isinstance(prompt, dict):
                        continue
                    try:
                        from comfyui_distributed_tpu_torch.workflow.orchestrate \
                            import register_recovery_redispatchers
                        register_recovery_redispatchers(st, prompt)
                    except Exception as e:  # noqa: BLE001 - local refine
                        debug_log(f"shard absorb redispatchers for "
                                  f"{pid} skipped: {e}")
                    try:
                        st.enqueue_prompt(
                            prompt, p.get("extra") or {},
                            client_id=p.get("client_id", "recovered"),
                            pid=pid, _recovered=True, _absorbed=True)
                    except Exception as e:  # noqa: BLE001 - one full
                        # queue must not abort the takeover half-done:
                        # the prompt stays open in the dead WAL (whose
                        # lease we keep holding) and in _pending_
                        # reenqueue, where the gossip loop re-drives it
                        # until it lands — without that retry it would
                        # be lost forever, since the dead member leaves
                        # every ring and its restart is fenced out
                        log(f"shard {self.id}: absorbed prompt {pid} "
                            f"not re-enqueued ({type(e).__name__}: "
                            f"{e}); left pending in {dead_id}'s WAL "
                            f"for retry")
                        failed_reenq[str(pid)] = p
                        continue
                    transferred.append(pid)
                    resumed += 1
                # ownership transfer completes in the DEAD shard's log:
                # close the transferred admissions there (under OUR
                # acquired epoch) so a restart of the dead master can
                # never replay prompts this survivor already took over
                try:
                    closer = dur.WriteAheadLog(ddir, epoch=epoch,
                                               lease=lease,
                                               tracker=replayed)
                    for pid in transferred:
                        closer.append("exec_done", pid=str(pid),
                                      status="absorbed")
                    closer.close()
                except Exception as e:  # noqa: BLE001 - the renewed
                    # lease still blocks a restart while we hold it
                    log(f"shard {self.id}: closing {dead_id}'s "
                        f"transferred prompts failed: {e}")
            else:
                resumed = 0
                failed_reenq = {}
            with self._lock:
                self._members.pop(dead_id, None)
                self._ring = HashRing(self._members, self._vnodes)
                self._ring_epoch += 1
                ring_epoch = self._ring_epoch
                self._peer_seen.pop(dead_id, None)
                self._peer_queue.pop(dead_id, None)
                self._absorbed[dead_id] = {
                    "epoch": epoch,
                    "ring_epoch": ring_epoch,
                    "resumed_prompts": resumed,
                    "recovered_jobs": len(replayed.jobs),
                    "at": self._clock.time(),
                }
                if failed_reenq:
                    self._pending_reenqueue[dead_id] = failed_reenq
            self.takeovers += 1
            trace_mod.GLOBAL_COUNTERS.bump("shard_takeovers")
            trace_mod.GLOBAL_COUNTERS.bump("shard_absorbed_prompts",
                                           resumed)
            self._rescale_admission()
            self._rehome_workers()
            try:
                self.gossip_once()
            except Exception:  # noqa: BLE001 - next round re-gossips
                pass
            log(f"shard {self.id}: absorbed {dead_id} (resumed "
                f"{resumed} prompt(s), ring epoch {ring_epoch})")
            with self._lock:
                return dict(self._absorbed[dead_id])
        finally:
            with self._lock:
                self._absorbing.discard(dead_id)

    def _rehome_workers(self) -> None:
        """Best-effort re-home of the config's workers to this master.
        Sharded workers already heartbeat EVERY master (one lease per
        shard), so this only matters for single-homed legacy workers
        from the config."""
        from comfyui_distributed_tpu_torch.runtime import durable as dur
        st = self._state
        if st is None or st.port is None:
            return
        url = self.member_url(self.id) \
            or f"http://127.0.0.1:{st.port}"
        dur.rehome_workers(url, st.config_path)

    # -- federation reads -----------------------------------------------------

    def peer_queue_depth(self) -> int:
        """Sum of the peers' last-gossiped queue depths — the merged
        half of the autoscaler's federated signal."""
        now = self._clock.monotonic()
        with self._lock:
            return sum(q for sid, q in self._peer_queue.items()
                       if now - self._peer_seen.get(sid, 0)
                       <= self.peer_down_s)

    def live_peer_masters(self) -> int:
        now = self._clock.monotonic()
        with self._lock:
            return sum(1 for sid in self._members
                       if sid != self.id
                       and now - self._peer_seen.get(sid, -1e9)
                       <= self.peer_down_s)

    def is_autoscale_actuator(self) -> bool:
        """True when this master is the ring-designated fleet-autoscale
        actuator: the owner of a fixed sentinel key on the CURRENT
        merged ring.  Every master folds the same gossiped backlog into
        its autoscale signal, so letting each one spawn/retire would
        react N times to ONE backlog; instead exactly one shard
        actuates for the fleet, and the role moves automatically with
        ring membership (a dead actuator's successor inherits the
        sentinel key along with its shard)."""
        if self.deposed:
            return False
        with self._lock:
            return self._ring.owner(C.AUTOSCALE_ACTUATOR_KEY) == self.id

    def snapshot(self) -> Dict[str, Any]:
        now = self._clock.monotonic()
        with self._lock:
            peers = {
                sid: {
                    "url": url,
                    "last_gossip_age_s": (
                        None if sid not in self._peer_seen else
                        round(now - self._peer_seen[sid], 3)),
                    "queue_remaining": self._peer_queue.get(sid),
                    "down": (sid != self.id
                             and now - self._peer_seen.get(sid, -1e9)
                             > self.peer_down_s),
                }
                for sid, url in self._members.items()}
            return {
                "enabled": True,
                "id": self.id,
                "deposed": self.deposed,
                "ring_epoch": self._ring_epoch,
                "vnodes": self._ring.vnodes,
                "members": peers,
                "owned": [self.id] + sorted(self._absorbed),
                "absorbed": dict(self._absorbed),
                "takeovers": self.takeovers,
                "forwards": self.forwards,
                "pending_reenqueue": {
                    sid: sorted(pids) for sid, pids
                    in self._pending_reenqueue.items() if pids},
                "wal_root": self.wal_root,
            }

    def ring_snapshot(self) -> Dict[str, Any]:
        """The ``GET /distributed/ring`` body: everything a client (or
        the stateless router) needs to hash prompt-ids itself."""
        snap = self.snapshot()
        return {
            "enabled": True,
            "self": self.id,
            "ring_epoch": snap["ring_epoch"],
            "vnodes": snap["vnodes"],
            "members": {sid: m["url"]
                        for sid, m in snap["members"].items()},
            "down": [sid for sid, m in snap["members"].items()
                     if m["down"]],
            "owned": snap["owned"],
        }

    @classmethod
    def attach(cls, state, cfg: Optional[Dict[str, Any]] = None,
               start_threads: bool = True) -> Optional["ShardManager"]:
        """Arm the shard plane on a master when ``DTPU_SHARD_ID`` is
        set (``cfg`` lets ServerState pass the config it already
        resolved for the WAL-dir derivation)."""
        cfg = cfg if cfg is not None else shard_config()
        if cfg is None or state.is_worker:
            return None
        return cls(state, cfg["id"], cfg["members"],
                   wal_root=cfg.get("wal_root"),
                   start_threads=start_threads)


# --- the stateless admission router ------------------------------------------

class RouterState:
    """The router's ONLY state: a refreshable cached ring.  Losing it
    costs one re-pull from a seed master — the router holds no queue,
    no WAL, no leases, and any number of replicas can run."""

    def __init__(self, masters: List[str],
                 refresh_s: Optional[float] = None):
        self.seeds = [u.rstrip("/") for u in masters if u.strip()]
        self.refresh_s = _env_float(C.ROUTER_REFRESH_ENV,
                                    C.ROUTER_REFRESH_DEFAULT) \
            if refresh_s is None else float(refresh_s)
        self._lock = threading.Lock()
        self._members: Dict[str, str] = {}     # guarded-by: self._lock
        self._ring: Optional[HashRing] = None  # guarded-by: self._lock
        self._ring_epoch = 0                   # guarded-by: self._lock
        self._fetched_at = 0.0                 # guarded-by: self._lock
        # replica-unique pid salt: any number of stateless router
        # replicas may mint ids concurrently, and a shared
        # "p_<ms>_r<counter>" namespace would collide across them
        self._salt = uuid.uuid4().hex[:8]
        self._counter = itertools.count()
        self.routed = 0
        self.rerouted = 0

    def adopt(self, ring_body: Dict[str, Any]) -> bool:
        members = ring_body.get("members")
        if not isinstance(members, dict) or not members:
            return False
        epoch = int(ring_body.get("ring_epoch", 1) or 1)
        with self._lock:
            if epoch < self._ring_epoch:
                return False
            self._members = {str(k): str(v or "")
                             for k, v in members.items()}
            self._ring = HashRing(self._members,
                                  ring_body.get("vnodes"))
            self._ring_epoch = epoch
            self._fetched_at = time.monotonic()
        return True

    def targets(self) -> List[str]:
        with self._lock:
            urls = [u for u in self._members.values() if u]
        return urls or list(self.seeds)

    def stale(self) -> bool:
        with self._lock:
            return (self._ring is None
                    or time.monotonic() - self._fetched_at
                    > self.refresh_s)

    def route(self, pid: str) -> Optional[tuple]:
        with self._lock:
            if self._ring is None:
                return None
            owner = self._ring.owner(pid)
            return owner, self._members.get(owner, "")

    def new_pid(self) -> str:
        return (f"p_{int(time.time() * 1000)}_r{self._salt}"
                f"_{next(self._counter)}")

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "router": True,
                "ring_epoch": self._ring_epoch,
                "members": dict(self._members),
                "seeds": list(self.seeds),
                "routed": self.routed,
                "rerouted": self.rerouted,
                "ring_age_s": (None if not self._fetched_at else
                               round(time.monotonic()
                                     - self._fetched_at, 3)),
            }


# --- the router's HTTP server ----------------------------------------------


def _router_routes(rs: RouterState):
    """(method, path) -> handler(body) -> (status, JSON body, extra
    headers): the routes of the JAX package's ``build_router_app``
    (``/distributed/fleet`` waits for the autoscaler)."""

    def refresh(force: bool = False) -> bool:
        if not force and not rs.stale():
            return True
        for url in rs.targets():
            try:
                status, body, _ = request_json(
                    "GET", f"{url}/distributed/ring", timeout=3)
                if status == 200 and isinstance(body, dict) \
                        and body.get("enabled") and rs.adopt(body):
                    return True
            except Exception as e:  # noqa: BLE001 - try the next seed
                debug_log(f"router: ring pull from {url} failed: {e}")
        return False

    def post_prompt(body: bytes):
        data = json.loads(body or b"{}")
        if not isinstance(data, dict):
            raise ValueError("a JSON object is expected")
        if not refresh():
            return 503, {"error": "router: no reachable master with an "
                                  "enabled ring"}, {}
        pid = str(data.get("prompt_id") or rs.new_pid())
        data = {**data, "prompt_id": pid}
        tried = set()
        for _attempt in range(2):
            routed = rs.route(pid)
            if routed is None or not routed[1] or routed[1] in tried:
                break
            owner, url = routed
            tried.add(url)
            try:
                status, out, hdrs = request_json(
                    "POST", f"{url}/prompt", data, timeout=120)
            except Exception as e:  # noqa: BLE001 - the owner died: re-pull
                debug_log(f"router: owner {owner} unreachable ({e}); "
                          "refreshing the ring")
                rs.rerouted += 1
                refresh(force=True)
                continue
            rs.routed += 1
            if isinstance(out, dict):
                out.setdefault("shard", owner)
            # a shed (429) keeps its Retry-After across the hop
            ra = hdrs.get("Retry-After")
            return status, out, ({"Retry-After": ra} if ra is not None
                                 else {})
        return 503, {"error": f"router: no reachable owner for {pid!r}"}, {}

    def fanout_json(path: str) -> Dict[str, Dict[str, Any]]:
        """GET ``path`` on every ring member: {shard: body} of those that
        answered."""
        refresh()
        members = [(sid, url) for sid, url
                   in rs.snapshot()["members"].items() if url]
        out: Dict[str, Dict[str, Any]] = {}

        def hit(item):
            sid, url = item
            try:
                status, body, _ = request_json("GET", f"{url}{path}",
                                               timeout=5)
                if status == 200 and isinstance(body, dict):
                    out[sid] = body
            except Exception as e:  # noqa: BLE001 - skip dead members
                debug_log(f"router: {path} from {sid} failed: {e}")

        if members:
            with concurrent.futures.ThreadPoolExecutor(len(members)) as ex:
                list(ex.map(hit, members))
        return out

    def ring(body: bytes):
        refresh()
        return 200, rs.snapshot(), {}

    def history(body: bytes):
        merged: Dict[str, Any] = {}
        for _sid, b in sorted(fanout_json("/history").items()):
            merged.update(b)
        return 200, merged, {}

    def cluster_metrics(body: bytes):
        """The shards' federated resources, keyed ``<shard>/<id>``."""
        parts: Dict[str, Any] = {}
        ttl = None
        per = fanout_json("/distributed/cluster/metrics")
        for sid, b in per.items():
            ttl = b.get("ttl_s", ttl)
            for wid, p in (b.get("participants") or {}).items():
                parts[f"{sid}/{wid}"] = p
        return 200, {"participants": parts, "ttl_s": ttl,
                     "shards": sorted(per)}, {}

    def cluster(body: bytes):
        """The shards' leases and ledgers, workers and jobs keyed per
        shard; the policy fields from the first shard that answered."""
        per = fanout_json("/distributed/cluster")
        merged: Dict[str, Any] = {"workers": {}, "transitions": [],
                                  "ledger": {"active_jobs": {},
                                             "completed_jobs": []},
                                  "shards": sorted(per)}
        for sid in sorted(per):
            b = per[sid]
            for k in ("policy", "hedge", "lease_s", "suspect_probes"):
                merged.setdefault(k, b.get(k))
            for wid, w in (b.get("workers") or {}).items():
                merged["workers"][f"{sid}/{wid}"] = w
            led = b.get("ledger") or {}
            for jid, j in (led.get("active_jobs") or {}).items():
                merged["ledger"]["active_jobs"][f"{sid}/{jid}"] = j
            merged["ledger"]["completed_jobs"].extend(
                led.get("completed_jobs") or [])
            merged["transitions"].extend(b.get("transitions") or [])
        return 200, merged, {}

    return {
        ("POST", "/prompt"): post_prompt,
        ("GET", "/distributed/ring"): ring,
        ("GET", "/history"): history,
        ("GET", "/distributed/cluster/metrics"): cluster_metrics,
        ("GET", "/distributed/cluster"): cluster,
    }


def make_router_server(masters: List[str], host: str = "127.0.0.1",
                       port: int = 8290,
                       refresh_s: Optional[float] = None
                       ) -> ThreadingHTTPServer:
    """The router bound (port 0 takes a free one); ``.router`` is its
    :class:`RouterState` and ``serve_forever()`` serves."""
    rs = RouterState(masters, refresh_s=refresh_s)
    table = _router_routes(rs)

    class Handler(BaseHTTPRequestHandler):
        def _dispatch(self, method: str) -> None:
            path = urllib.parse.urlsplit(self.path).path
            fn = table.get((method, path))
            extra: Dict[str, str] = {}
            try:
                body = self.rfile.read(int(
                    self.headers.get("Content-Length") or 0))
                if fn is None:
                    status, payload = 404, {"error": f"no route {method} "
                                                     f"{path}"}
                else:
                    status, payload, extra = fn(body)
            except ValueError as e:
                status, payload = 400, {"error": str(e)}
            except Exception as e:  # noqa: BLE001 - a 500, not a dead thread
                traceback.print_exc()
                status, payload = 500, {"error": str(e)}
            data = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            for k, v in extra.items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self) -> None:
            self._dispatch("GET")

        def do_POST(self) -> None:
            self._dispatch("POST")

        def log_message(self, fmt: str, *args) -> None:
            pass

    server = ThreadingHTTPServer((host, port), Handler)
    server.daemon_threads = True
    server.router = rs
    return server

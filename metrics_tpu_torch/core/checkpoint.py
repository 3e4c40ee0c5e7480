"""Preemption-safe durable checkpointing for metrics and collections.

Counterpart of ``metrics_tpu/core/checkpoint.py``, with the same three
guarantees and the same bytes on disk:

1. **Atomic durable snapshots.** :func:`save_checkpoint` serializes the
   (pre-sync, rank-local) state of a :class:`~metrics_tpu_torch.Metric` or
   :class:`~metrics_tpu_torch.MetricCollection` into one self-verifying
   file: the 8-byte magic ``MTPUCKPT``, a ``<QI`` preamble (manifest length,
   manifest CRC32), the JSON manifest (``sort_keys``, compact separators,
   ``"format": "metrics_tpu.checkpoint"``) and a payload whose every leaf is
   covered by its own CRC32. The file is written temp → ``fsync`` → atomic
   rename, then the directory is fsynced, so a kill at any byte offset leaves
   the previous complete snapshot or an ignorable temp file.
2. **Verified restore.** :func:`load_checkpoint` verifies the whole file
   (magic, manifest CRC, payload length, every leaf CRC), migrates older
   manifests through :func:`register_manifest_migration` hooks and checks the
   schema against the target, all before any state changes. Corruption raises
   :class:`~metrics_tpu_torch.utils.exceptions.CheckpointCorruptError`,
   schema divergence :class:`~metrics_tpu_torch.utils.exceptions.StateSchemaError`.
   Restored leaves go to the metric's own device.
3. **Elastic resume.** A snapshot of ``W`` shards restores into ``W'`` ranks:
   shard ``i`` goes to rank ``i % W'`` and is folded in with ``merge_state``;
   a surplus rank of a scale-up resets. Grouped collections write one state
   per compute group and record the siblings as ``alias_of`` entries.

Layout: ``<directory>/step_%010d/shard_%05d_of_%05d.mtck``; a step is complete
once all ``world`` shards exist under their final names.

**Files across the two packages.** The format is framework-neutral (numpy
dtype names and raw little-endian bytes), so a file written by the JAX
package loads here. The JAX package counts in int32 and this package in
int64; the schema check accepts exactly one move beyond the JAX package's
rule (float to float): an integer leaf widened to a wider integer of the
same signedness, which the load then performs. The other way is refused by
the JAX loader (``int64 (saved) vs int32 (target)``): files cross one way
only. A ``state_fingerprint`` names torch dtypes, so fingerprints never match
across packages and the structural check decides those loads. bfloat16
leaves are written as their raw 16-bit words under the dtype name
``"bfloat16"`` (the JAX reader resolves it through ``ml_dtypes``) and read
back by reinterpreting the words, with no ``ml_dtypes`` here.

**Telemetry.** Saves, loads, pruned steps, auto-snapshots and refusals of
a synced state count in the target's ``checkpoint`` telemetry domain, and
``checkpoint.save``/``load``/``prune``/``refused`` are journaled (per-rank
facts: each rank writes its own shard). Not ported yet: the refusal of a
snapshot while a non-blocking sync round is in flight (the port has no such
round yet). The JAX package's refusal of traced state is a refusal while a
CUDA graph is being captured here.
"""
import json
import os
import re
import shutil
import struct
import tempfile
import zlib
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import torch

from metrics_tpu_torch.core.cat_buffer import CatBuffer
from metrics_tpu_torch.core.collections import MetricCollection
from metrics_tpu_torch.core.metric import Metric, _cast_floating
from metrics_tpu_torch.observability import journal
from metrics_tpu_torch.observability.registry import registry_of
from metrics_tpu_torch.parallel.health import (
    fingerprint_crc,
    state_poisoned,
    state_schema_hash,
    state_schema_parts,
)
from metrics_tpu_torch.utils.exceptions import (
    CheckpointCorruptError,
    CheckpointError,
    MetricsTPUUserError,
    StateSchemaError,
)
from metrics_tpu_torch.utils.prints import rank_zero_warn

__all__ = [
    "MANIFEST_VERSION",
    "MetricCheckpointer",
    "available_steps",
    "latest_step",
    "load_checkpoint",
    "prune_checkpoints",
    "register_manifest_migration",
    "save_checkpoint",
]

#: Current manifest schema revision (the JAX package's).
MANIFEST_VERSION = 1

#: File magic: the first 8 bytes of every shard file.
_MAGIC = b"MTPUCKPT"

#: ``<header_len:u64><header_crc:u32>`` immediately after the magic.
_HEADER_STRUCT = struct.Struct("<QI")
_PREAMBLE_LEN = len(_MAGIC) + _HEADER_STRUCT.size

#: Manifest key a bare (non-collection) metric's record is stored under.
_SINGLE_KEY = "__metric__"

_STEP_DIR_RE = re.compile(r"^step_(\d{10})$")
_SHARD_RE = re.compile(r"^shard_(\d{5})_of_(\d{5})\.mtck$")

#: Migration hook table: ``{from_version: manifest -> manifest}``.
_MIGRATIONS: Dict[int, Callable[[Dict[str, Any]], Dict[str, Any]]] = {}


def register_manifest_migration(
    from_version: int, fn: Callable[[Dict[str, Any]], Dict[str, Any]]
) -> None:
    """Register a manifest migration hook for checkpoints written at an
    older ``manifest_version``. The hook receives the parsed (CRC-verified)
    manifest dict and must return an upgraded manifest with a strictly
    larger ``manifest_version``; hooks chain until the current version."""
    _MIGRATIONS[int(from_version)] = fn


def _default_coordinates(rank: Optional[int], world: Optional[int]) -> Tuple[int, int]:
    """``(rank, world)``: the arguments where given, else the initialized
    default process group's, else ``(0, 1)``."""
    initialized = torch.distributed.is_available() and torch.distributed.is_initialized()
    if rank is None:
        rank = torch.distributed.get_rank() if initialized else 0
    if world is None:
        world = torch.distributed.get_world_size() if initialized else 1
    return int(rank), int(world)


def _capturing() -> bool:
    """True while the current CUDA stream is capturing a graph: no host copy
    of state can be taken then."""
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


# ---------------------------------------------------------------------------
# payload encoding (state value <-> manifest entry + raw bytes)
# ---------------------------------------------------------------------------


def _dtype_name(dtype: torch.dtype) -> str:
    """The numpy name of a torch dtype (``torch.int64`` -> ``"int64"``;
    ``torch.bfloat16`` -> ``"bfloat16"``, the ``ml_dtypes`` name)."""
    return str(dtype).replace("torch.", "")


def _resolve_dtype(name: str) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise CheckpointError(f"checkpoint leaf dtype {name!r} has no torch counterpart.")
    return dtype


class _PayloadWriter:
    """Copies state leaves to the host and appends their raw bytes, tracking
    offsets and per-leaf CRC32s."""

    def __init__(self) -> None:
        self.segments: List[memoryview] = []
        self.offset = 0

    def add(self, value: Any) -> Dict[str, Any]:
        host = torch.as_tensor(value).detach().to("cpu").contiguous()
        # raw little-endian words; bfloat16 included, with no numpy dtype
        data = memoryview(host.reshape(-1).view(torch.uint8).numpy())
        crc = zlib.crc32(data) & 0xFFFFFFFF
        entry = {
            "kind": "array",
            "dtype": _dtype_name(host.dtype),
            "shape": list(host.shape),
            "offset": self.offset,
            "nbytes": len(data),
            "crc": crc,
        }
        self.segments.append(data)
        self.offset += len(data)
        return entry


def _encode_state_value(value: Any, writer: _PayloadWriter) -> Dict[str, Any]:
    if isinstance(value, CatBuffer):
        return {
            "kind": "catbuf",
            "capacity": int(value.capacity),
            "count": int(value.count),
            "overflowed": bool(value.overflowed),
            "buffer": {"kind": "none"} if value.buffer is None else writer.add(value.buffer),
        }
    if isinstance(value, (list, tuple)):
        return {"kind": "list", "items": [writer.add(x) for x in value]}
    return writer.add(value)


def _read_array_entry(entry: Dict[str, Any], payload: memoryview, path: str) -> torch.Tensor:
    offset, nbytes = int(entry["offset"]), int(entry["nbytes"])
    if offset < 0 or nbytes < 0 or offset + nbytes > len(payload):
        raise CheckpointCorruptError(
            f"checkpoint {path!r}: leaf segment [{offset}, {offset + nbytes}) exceeds "
            f"the {len(payload)}-byte payload — file is corrupt."
        )
    data = payload[offset : offset + nbytes]
    if (zlib.crc32(data) & 0xFFFFFFFF) != int(entry["crc"]):
        raise CheckpointCorruptError(
            f"checkpoint {path!r}: CRC mismatch on a state leaf at payload offset "
            f"{offset} — file is corrupt (bit rot or a torn write)."
        )
    dtype = _resolve_dtype(entry["dtype"])
    shape = tuple(int(d) for d in entry["shape"])
    numel = 1
    for d in shape:
        numel *= d
    if numel * dtype.itemsize != nbytes:
        raise CheckpointCorruptError(
            f"checkpoint {path!r}: a {entry['dtype']}{list(shape)} leaf cannot hold {nbytes} bytes — "
            "manifest is inconsistent."
        )
    if nbytes == 0:
        return torch.empty(shape, dtype=dtype)
    # a writable copy, reinterpreted: bfloat16 words need no ml_dtypes
    return torch.frombuffer(bytearray(data), dtype=dtype).reshape(shape)


def _decode_state_entry(entry: Dict[str, Any], payload: memoryview, path: str) -> Any:
    """Manifest entry -> ``state_dict``-format value (host tensors; CatBuffer
    states as the ``__catbuffer__`` record ``Metric.load_state_dict`` takes)."""
    kind = entry.get("kind")
    if kind == "array":
        return _read_array_entry(entry, payload, path)
    if kind == "list":
        return [_read_array_entry(e, payload, path) for e in entry["items"]]
    if kind == "catbuf":
        buf = entry["buffer"]
        return {
            "__catbuffer__": int(entry["capacity"]),
            "buffer": None if buf.get("kind") == "none" else _read_array_entry(buf, payload, path),
            "count": int(entry["count"]),
            "overflowed": bool(entry["overflowed"]),
        }
    raise CheckpointCorruptError(
        f"checkpoint {path!r}: unknown state-entry kind {kind!r} — file is corrupt "
        "or written by an incompatible version."
    )


def _sd_value_to_live(value: Any, device: torch.device) -> Any:
    """``state_dict``-format value -> live state value on ``device`` for
    ``merge_state``."""
    if isinstance(value, dict) and "__catbuffer__" in value:
        buf = value["buffer"]
        return CatBuffer(
            int(value["__catbuffer__"]),
            None if buf is None else buf.to(device),
            int(value["count"]),
            bool(value["overflowed"]),
        )
    if isinstance(value, list):
        return [x.to(device) for x in value]
    return value.to(device)


# ---------------------------------------------------------------------------
# snapshot build (metric -> manifest + payload)
# ---------------------------------------------------------------------------


def _fx_tag(fx: Any) -> Optional[str]:
    if fx is None or isinstance(fx, str):
        return fx
    return "callable"


def _refuse_snapshot(m: Metric, reason: str) -> None:
    """Count and journal a refused snapshot before the typed error raises, so
    that a stalled checkpoint cadence shows why in ``telemetry()``."""
    registry_of(m).inc("checkpoint", "refused")
    if journal.ACTIVE:
        journal.record("checkpoint.refused", label=type(m).__name__, step=m._update_count, reason=reason)


def _metric_record(m: Metric, writer: _PayloadWriter) -> Dict[str, Any]:
    if m.__dict__.get("_inflight") is not None or m.__dict__.get("_inflight_collection") is not None:
        # refuse rather than drain: the live state holds only the delta since
        # a non-blocking round took the accumulation, and draining here would
        # put a collective stall into the checkpoint cadence
        _refuse_snapshot(m, "in-flight non-blocking sync round")
        raise MetricsTPUUserError(
            f"save_checkpoint: {type(m).__name__} has a non-blocking sync round in flight — the live state "
            "holds only the post-snapshot delta. Resolve the round (compute()/sync()) or cancel it "
            "(unsync()) before snapshotting."
        )
    if m._is_synced:
        _refuse_snapshot(m, "state is synced (snapshots serialize pre-sync state)")
        raise MetricsTPUUserError(
            f"save_checkpoint: {type(m).__name__} is currently synced. Snapshots "
            "serialize the PRE-sync rank-local state (so elastic resume can fold "
            "shards without double counting); call unsync() first, or snapshot "
            "outside the sync_context."
        )
    if _capturing():
        raise MetricsTPUUserError(
            f"save_checkpoint: {type(m).__name__}'s state is being captured into a "
            "CUDA graph — checkpointing is a host-side (eager) operation and cannot "
            "copy state mid-capture. Snapshot outside the capture."
        )
    state = m._state
    overflow = any(isinstance(v, CatBuffer) and v.overflowed for v in state.values())
    return {
        "type": type(m).__name__,
        "update_count": int(m._update_count),
        "overflow": overflow,
        "poisoned": bool(state_poisoned(state)),
        "fingerprint_crc": fingerprint_crc(m.state_fingerprint()),
        "schema": state_schema_parts(state, m._reductions),
        "schema_crc": state_schema_hash(state, m._reductions),
        "reductions": {name: _fx_tag(m._reductions.get(name)) for name in m._defaults},
        "states": {name: _encode_state_value(state[name], writer) for name in m._defaults},
    }


def _build_snapshot(
    metric: Union[Metric, MetricCollection], *, step: int, rank: int, world: int
) -> Tuple[Dict[str, Any], _PayloadWriter]:
    writer = _PayloadWriter()
    records: Dict[str, Dict[str, Any]] = {}
    groups: List[List[str]] = []
    if isinstance(metric, MetricCollection):
        kind = "collection"
        groups = metric.compute_group_keys
        key_by_id = {id(m): k for k, m in metric.items()}
        for key, m, peers in metric._sync_state_owners():
            records[key] = _metric_record(m, writer)
            for p in peers:
                # compute-group siblings share the leader's state: snapshot
                # it once and record the siblings as aliases
                records[key_by_id[id(p)]] = {
                    "type": type(p).__name__,
                    "update_count": int(p._update_count),
                    "fingerprint_crc": fingerprint_crc(p.state_fingerprint()),
                    "alias_of": key,
                }
        # manifest in collection order (restore iterates the manifest)
        records = {k: records[k] for k, _m in metric.items()}
    elif isinstance(metric, Metric):
        kind = "metric"
        records[_SINGLE_KEY] = _metric_record(metric, writer)
    else:
        raise MetricsTPUUserError(
            f"save_checkpoint expects a Metric or MetricCollection, got {type(metric).__name__}"
        )
    manifest = {
        "format": "metrics_tpu.checkpoint",
        "manifest_version": MANIFEST_VERSION,
        "kind": kind,
        "step": int(step),
        "rank": int(rank),
        "world": int(world),
        "payload_nbytes": writer.offset,
        "groups": groups,
        "metrics": records,
    }
    return manifest, writer


def _pack(manifest: Dict[str, Any], segments: Sequence[Any]) -> List[Any]:
    """The file's bytes as a list of buffers: magic, preamble, manifest,
    then the payload's segments (written in turn, never joined)."""
    header = json.dumps(manifest, sort_keys=True, separators=(",", ":")).encode()
    return [_MAGIC + _HEADER_STRUCT.pack(len(header), zlib.crc32(header) & 0xFFFFFFFF) + header, *segments]


# ---------------------------------------------------------------------------
# atomic file + directory layout
# ---------------------------------------------------------------------------


def _atomic_write(path: str, blobs: Sequence[Any]) -> None:
    """temp file in the destination directory -> fsync -> atomic rename ->
    directory fsync. A kill at any byte offset leaves only an ignorable
    ``.tmp-*`` file; the final name appears complete or not at all."""
    directory = os.path.dirname(path)
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, prefix=".tmp-", suffix=".mtck")
    try:
        with os.fdopen(fd, "wb") as f:
            for blob in blobs:
                f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    try:
        dir_fd = os.open(directory, os.O_RDONLY)
        try:
            os.fsync(dir_fd)
        finally:
            os.close(dir_fd)
    except OSError:
        pass  # some filesystems refuse directory fsync; rename is still atomic


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{int(step):010d}")


def _shard_name(rank: int, world: int) -> str:
    return f"shard_{int(rank):05d}_of_{int(world):05d}.mtck"


def available_steps(directory: str) -> List[int]:
    """Snapshot step numbers present under ``directory`` (ascending; a step
    may still be incomplete — see :func:`load_checkpoint`)."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        match = _STEP_DIR_RE.match(name)
        if match and os.path.isdir(os.path.join(directory, name)):
            steps.append(int(match.group(1)))
    return sorted(steps)


def latest_step(directory: str) -> Optional[int]:
    """The newest snapshot step under ``directory`` (complete or not), or
    ``None`` when the directory holds no snapshots."""
    steps = available_steps(directory)
    return steps[-1] if steps else None


def _shard_files(step_directory: str) -> Tuple[int, Dict[int, str]]:
    """``(world, {rank: path})`` for one step directory. Mixed-world shard
    sets (two jobs clobbering one step) are corruption, not a race."""
    shards: Dict[int, str] = {}
    worlds: set = set()
    if os.path.isdir(step_directory):
        for name in sorted(os.listdir(step_directory)):
            match = _SHARD_RE.match(name)
            if not match:
                continue
            shards[int(match.group(1))] = os.path.join(step_directory, name)
            worlds.add(int(match.group(2)))
    if not shards:
        return 0, {}
    if len(worlds) != 1:
        raise CheckpointCorruptError(
            f"checkpoint step {step_directory!r} holds shards from different world "
            f"sizes {sorted(worlds)} — two jobs wrote the same step. Remove the "
            "stale shards before resuming."
        )
    return worlds.pop(), shards


def _snapshot_complete(step_directory: str) -> bool:
    world, shards = _shard_files(step_directory)
    return world > 0 and set(shards) == set(range(world))


def _complete_steps(directory: str) -> List[int]:
    return [s for s in available_steps(directory) if _snapshot_complete(_step_dir(directory, s))]


def prune_checkpoints(directory: str, keep_last: int) -> List[int]:
    """Delete snapshots older than the ``keep_last`` newest *complete* ones.

    Incomplete steps newer than the retention cutoff are left alone (another
    rank may still be renaming its shard); incomplete steps older than the
    cutoff are dead weight from past preemptions and are removed. Returns
    the pruned step numbers.
    """
    if keep_last < 1:
        raise MetricsTPUUserError(f"keep_last must be >= 1, got {keep_last}")
    complete = _complete_steps(directory)[::-1]
    if len(complete) <= keep_last:
        return []
    cutoff = complete[keep_last - 1]
    pruned = [s for s in available_steps(directory) if s < cutoff]
    for s in pruned:
        shutil.rmtree(_step_dir(directory, s), ignore_errors=True)
    return pruned


# ---------------------------------------------------------------------------
# save
# ---------------------------------------------------------------------------


def save_checkpoint(
    metric: Union[Metric, MetricCollection],
    directory: str,
    *,
    step: Optional[int] = None,
    rank: Optional[int] = None,
    world: Optional[int] = None,
    keep_last: Optional[int] = None,
) -> str:
    """Atomically snapshot a metric/collection's rank-local state.

    Writes this rank's shard file under ``directory/step_<step>/`` via
    write-temp → fsync → atomic rename: a preemption mid-save can never
    leave a readable-but-corrupt file. ``rank``/``world`` default to the
    initialized ``torch.distributed`` process group's rank and size (0 and 1
    without one); pass them explicitly to simulate a world (tests) or to
    write a consolidated ``world=1`` checkpoint. ``step`` defaults to one
    past the newest step already in ``directory``. With ``keep_last``, rank
    0 prunes snapshots older than the ``keep_last`` newest complete ones
    after a successful save.

    Returns the shard file path.

    Example:
        >>> import tempfile, torch
        >>> from metrics_tpu_torch import Accuracy, load_checkpoint, save_checkpoint
        >>> acc = Accuracy(device="cpu")
        >>> acc.update(torch.tensor([0, 1, 1]), torch.tensor([0, 1, 0]))
        >>> d = tempfile.mkdtemp()
        >>> save_checkpoint(acc, d, rank=0, world=1).endswith("shard_00000_of_00001.mtck")
        True
        >>> round(float(load_checkpoint(Accuracy(device="cpu"), d, rank=0, world=1).compute()), 4)
        0.6667
    """
    rank, world = _default_coordinates(rank, world)
    if world < 1 or not (0 <= rank < world):
        raise MetricsTPUUserError(
            f"save_checkpoint: invalid shard coordinates rank={rank}, world={world}"
        )
    if step is None:
        newest = latest_step(directory)
        if newest is None:
            step = 0
        else:
            newest_world, newest_shards = _shard_files(_step_dir(directory, newest))
            if newest_world == world and rank not in newest_shards:
                # join the snapshot a peer rank already started (ranks save
                # the same step without coordinating)
                step = newest
            else:
                step = newest + 1
    # the transitive record() under here is _refuse_snapshot's: refusal
    # events are per-rank facts by design (each rank snapshots its own
    # shard), like the save/load/prune events below
    manifest, writer = _build_snapshot(metric, step=step, rank=rank, world=world)  # metricslint: disable=guarded-telemetry-emit
    path = os.path.join(_step_dir(directory, step), _shard_name(rank, world))
    _atomic_write(path, _pack(manifest, writer.segments))
    registry_of(metric).inc("checkpoint", "saves")
    if journal.ACTIVE:
        # checkpoint events are per-rank facts by design: every rank writes
        # its own shard, so the journal records this rank's save (cross-rank
        # symmetry is a sync/collective contract, not a durability one)
        journal.record(  # metricslint: disable=guarded-telemetry-emit
            "checkpoint.save", label=type(metric).__name__, step=step, rank=rank, world=world, bytes=writer.offset,
        )
    if keep_last is not None and rank == 0:
        pruned = prune_checkpoints(directory, keep_last)
        if pruned:
            # retention runs on rank 0 only: the event mirrors the deletion
            registry_of(metric).inc("checkpoint", "pruned_steps", by=len(pruned))
            if journal.ACTIVE:
                journal.record(  # metricslint: disable=guarded-telemetry-emit
                    "checkpoint.prune", label=type(metric).__name__, steps=",".join(map(str, pruned)))
    return path


# ---------------------------------------------------------------------------
# verified read
# ---------------------------------------------------------------------------


def _read_manifest(path: str) -> Tuple[Dict[str, Any], memoryview]:
    """Read + fully verify one shard file: magic, header CRC, payload length.
    Per-leaf CRCs verify when the leaves decode. Raises
    :class:`CheckpointCorruptError` on any byte-level failure."""
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError as err:
        raise CheckpointError(f"cannot read checkpoint shard {path!r}: {err}") from err
    if len(blob) < _PREAMBLE_LEN:
        raise CheckpointCorruptError(
            f"checkpoint {path!r} is truncated ({len(blob)} bytes, shorter than the "
            f"{_PREAMBLE_LEN}-byte preamble)."
        )
    if blob[: len(_MAGIC)] != _MAGIC:
        raise CheckpointCorruptError(
            f"checkpoint {path!r} has a bad magic — not a metrics_tpu checkpoint, "
            "or the file header was corrupted."
        )
    header_len, header_crc = _HEADER_STRUCT.unpack_from(blob, len(_MAGIC))
    if header_len > len(blob) - _PREAMBLE_LEN:
        raise CheckpointCorruptError(
            f"checkpoint {path!r} is truncated: manifest claims {header_len} header "
            f"bytes but only {len(blob) - _PREAMBLE_LEN} remain."
        )
    header = blob[_PREAMBLE_LEN : _PREAMBLE_LEN + header_len]
    if (zlib.crc32(header) & 0xFFFFFFFF) != header_crc:
        raise CheckpointCorruptError(
            f"checkpoint {path!r}: manifest CRC mismatch — the header bytes were "
            "corrupted after write."
        )
    try:
        manifest = json.loads(header.decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as err:  # pragma: no cover - CRC guards
        raise CheckpointCorruptError(f"checkpoint {path!r}: manifest is unparseable: {err}") from err
    manifest = _migrate_manifest(manifest, path)
    payload = memoryview(blob)[_PREAMBLE_LEN + header_len :]
    if len(payload) != int(manifest.get("payload_nbytes", -1)):
        raise CheckpointCorruptError(
            f"checkpoint {path!r} is truncated: manifest claims "
            f"{manifest.get('payload_nbytes')} payload bytes, file holds {len(payload)}."
        )
    return manifest, payload


def _migrate_manifest(manifest: Dict[str, Any], path: str) -> Dict[str, Any]:
    version = manifest.get("manifest_version")
    if not isinstance(version, int):
        raise CheckpointCorruptError(
            f"checkpoint {path!r}: manifest has no integer manifest_version."
        )
    if version > MANIFEST_VERSION:
        raise CheckpointError(
            f"checkpoint {path!r} was written at manifest v{version}, newer than this "
            f"library's v{MANIFEST_VERSION} — upgrade metrics_tpu_torch to resume it."
        )
    while version < MANIFEST_VERSION:
        hook = _MIGRATIONS.get(version)
        if hook is None:
            raise CheckpointError(
                f"checkpoint {path!r} was written at manifest v{version} and no "
                f"migration to v{MANIFEST_VERSION} is registered "
                "(register_manifest_migration)."
            )
        manifest = hook(manifest)
        new_version = manifest.get("manifest_version")
        if not isinstance(new_version, int) or new_version <= version:
            raise CheckpointError(
                f"manifest migration from v{version} did not advance the version "
                f"(got {new_version!r})."
            )
        version = new_version
    return manifest


def _decode_shard(path: str) -> Dict[str, Any]:
    """Verify one shard end to end and decode every metric's state into
    ``state_dict`` format on the host. All CRC work happens here — before
    any state mutation anywhere."""
    manifest, payload = _read_manifest(path)
    decoded: Dict[str, Dict[str, Any]] = {}
    for key, rec in manifest.get("metrics", {}).items():
        if "alias_of" in rec:
            continue
        decoded[key] = {
            name: _decode_state_entry(entry, payload, path)
            for name, entry in rec.get("states", {}).items()
        }
    for key, rec in manifest.get("metrics", {}).items():
        if "alias_of" in rec:
            leader = rec["alias_of"]
            if leader not in decoded:
                raise CheckpointCorruptError(
                    f"checkpoint {path!r}: member {key!r} aliases {leader!r}, which "
                    "holds no state — manifest is inconsistent."
                )
            decoded[key] = decoded[leader]
    return {"manifest": manifest, "states": decoded, "path": path}


# ---------------------------------------------------------------------------
# schema validation (before any mutation)
# ---------------------------------------------------------------------------


def _declared_leaf_desc(m: Metric, name: str) -> Dict[str, Any]:
    default = m._defaults[name]
    fx = _fx_tag(m._reductions.get(name))
    if isinstance(default, CatBuffer):
        live = getattr(m, name)
        ref = live if isinstance(live, CatBuffer) and live.buffer is not None else default
        item = None if ref.buffer is None else (_dtype_name(ref.buffer.dtype), tuple(ref.buffer.shape[1:]))
        return {"family": "cat", "kind": "catbuf", "item": item, "fx": fx}
    if isinstance(default, list):
        return {"family": "cat", "kind": "list", "item": None, "fx": fx}
    if fx in ("cat", None):
        return {"family": "cat", "kind": "leaf", "item": (_dtype_name(default.dtype), tuple(default.shape[1:])), "fx": fx}
    return {"family": "reduce", "kind": "leaf", "item": (_dtype_name(default.dtype), tuple(default.shape)), "fx": fx}


def _saved_leaf_desc(entry: Dict[str, Any], fx: Optional[str]) -> Dict[str, Any]:
    kind = entry.get("kind")
    if kind == "catbuf":
        buf = entry["buffer"]
        item = None if buf.get("kind") == "none" else (buf["dtype"], tuple(buf["shape"][1:]))
        return {"family": "cat", "kind": "catbuf", "item": item, "fx": fx}
    if kind == "list":
        items = entry["items"]
        item = None if not items else (items[0]["dtype"], tuple(items[0]["shape"][1:]))
        return {"family": "cat", "kind": "list", "item": item, "fx": fx}
    if fx in ("cat", None):
        return {"family": "cat", "kind": "leaf", "item": (entry["dtype"], tuple(entry["shape"][1:])), "fx": fx}
    return {"family": "reduce", "kind": "leaf", "item": (entry["dtype"], tuple(entry["shape"])), "fx": fx}


def _is_integer(dtype: torch.dtype) -> bool:
    return not (dtype.is_floating_point or dtype.is_complex or dtype == torch.bool)


def _widens(saved: torch.dtype, target: torch.dtype) -> bool:
    """An integer leaf into a wider integer of the same signedness: the
    JAX package's int32 counts into this package's int64 states."""
    return (
        _is_integer(saved)
        and _is_integer(target)
        and saved.is_signed == target.is_signed
        and saved.itemsize < target.itemsize
    )


def _dtype_compatible(a: str, b: str) -> bool:
    """Exact match; a float <-> float move (``set_dtype`` between save and
    load casts floating leaves; the restore re-casts, so precision moves are
    legal); or an integer widened to a wider integer of the same signedness,
    which the restore performs. Narrowing, and integer/bool kind changes,
    are real divergence."""
    if a == b:
        return True
    try:
        da, db = _resolve_dtype(a), _resolve_dtype(b)
    except CheckpointError:
        return False
    return (da.is_floating_point and db.is_floating_point) or _widens(da, db)


def _leaf_divergences(name: str, saved: Dict[str, Any], target: Dict[str, Any]) -> List[str]:
    out = []
    if saved["fx"] != target["fx"]:
        out.append(f"{name}: reduction {saved['fx']!r} (saved) vs {target['fx']!r} (target)")
    if saved["family"] != target["family"]:
        out.append(f"{name}: {saved['kind']} (saved) vs {target['kind']} (target)")
        return out
    if saved["family"] == "reduce":
        (sd, ss), (td, ts) = saved["item"], target["item"]
        if ss != ts:
            out.append(f"{name}: shape {ss} (saved) vs {ts} (target)")
        if not _dtype_compatible(sd, td):
            out.append(f"{name}: dtype {sd} (saved) vs {td} (target)")
        return out
    # cat family: catbuf/list/leaf interchange is legal (load_state_dict
    # normalizes kinds); compare item specs only when both sides know them
    if saved["item"] is not None and target["item"] is not None:
        (sd, ss), (td, ts) = saved["item"], target["item"]
        if ss != ts:
            out.append(f"{name}: item shape {ss} (saved) vs {ts} (target)")
        if not _dtype_compatible(sd, td):
            out.append(f"{name}: item dtype {sd} (saved) vs {td} (target)")
    return out


def _validate_metric_record(m: Metric, rec: Dict[str, Any], key: str, path: str) -> None:
    if rec.get("fingerprint_crc") == fingerprint_crc(m.state_fingerprint()):
        return  # identical declared schema — the fast path
    states = rec.get("states", {})
    reductions = rec.get("reductions", {})
    declared = list(m._defaults)
    missing = [n for n in declared if n not in states]
    unexpected = [n for n in states if n not in m._defaults]
    divergent: List[str] = []
    for name in declared:
        if name not in states:
            continue
        divergent.extend(
            _leaf_divergences(
                name, _saved_leaf_desc(states[name], reductions.get(name)), _declared_leaf_desc(m, name)
            )
        )
    if missing or unexpected or divergent:
        label = f"{type(m).__name__}" if key == _SINGLE_KEY else f"{key!r} ({type(m).__name__})"
        raise StateSchemaError(
            f"checkpoint {path!r} does not match {label}: "
            + "; ".join(
                ([f"states missing from the checkpoint: {missing}"] if missing else [])
                + ([f"checkpoint states with no declared counterpart: {unexpected}"] if unexpected else [])
                + divergent
            )
        )
    # fingerprints differ only in ways the structural check tolerates
    # (float dtype moves, integer widening, reset-default bytes, CatBuffer
    # capacity, the other package's dtype names): legal.


def _validate_shard(metric: Union[Metric, MetricCollection], shard: Dict[str, Any]) -> None:
    manifest, path = shard["manifest"], shard["path"]
    records: Dict[str, Any] = manifest.get("metrics", {})
    if isinstance(metric, MetricCollection):
        if manifest.get("kind") != "collection":
            raise StateSchemaError(
                f"checkpoint {path!r} holds a bare metric but the target is a "
                "MetricCollection."
            )
        target_keys = list(metric.keys())
        missing = [k for k in target_keys if k not in records]
        unexpected = [k for k in records if k not in set(target_keys)]
        if missing or unexpected:
            raise StateSchemaError(
                f"checkpoint {path!r} member keys do not match the collection: "
                f"missing {missing}, unexpected {unexpected}."
            )
        for key, m in metric.items():
            rec = records[key]
            if "alias_of" in rec:
                leader = records.get(rec["alias_of"])
                if leader is None or "states" not in leader:
                    raise CheckpointCorruptError(
                        f"checkpoint {path!r}: member {key!r} aliases "
                        f"{rec['alias_of']!r}, which holds no state — manifest is "
                        "inconsistent."
                    )
                rec = {**leader, "fingerprint_crc": rec.get("fingerprint_crc")}
            _validate_metric_record(m, rec, key, path)
    else:
        if manifest.get("kind") != "metric":
            raise StateSchemaError(
                f"checkpoint {path!r} holds a MetricCollection but the target is a "
                f"bare {type(metric).__name__}."
            )
        if _SINGLE_KEY not in records:
            raise CheckpointCorruptError(f"checkpoint {path!r}: no metric record found.")
        _validate_metric_record(metric, records[_SINGLE_KEY], _SINGLE_KEY, path)


# ---------------------------------------------------------------------------
# load + elastic fold
# ---------------------------------------------------------------------------


def _resolve_snapshot(directory: str, step: Optional[int]) -> Tuple[int, int, Dict[int, str]]:
    """``(step, world, {rank: path})`` of the snapshot to restore. With
    ``step=None``, the newest COMPLETE step wins; steps a preemption left
    partially renamed are skipped with a warning. An explicitly requested
    incomplete step raises."""
    steps = available_steps(directory)
    if step is not None:
        if int(step) not in steps:
            raise CheckpointError(
                f"no checkpoint for step {step} under {directory!r} "
                f"(available: {steps or 'none'})."
            )
        world, shards = _shard_files(_step_dir(directory, int(step)))
        missing = sorted(set(range(world)) - set(shards)) if world else ["all"]
        if missing:
            raise CheckpointError(
                f"checkpoint step {step} under {directory!r} is incomplete: missing "
                f"shard(s) for rank(s) {missing} of world {world}."
            )
        return int(step), world, shards
    for s in reversed(steps):
        world, shards = _shard_files(_step_dir(directory, s))
        if world > 0 and set(shards) == set(range(world)):
            return s, world, shards
        rank_zero_warn(
            f"skipping incomplete checkpoint step {s} under {directory!r} "
            "(a preemption interrupted the save); falling back to the previous "
            "complete snapshot.",
            RuntimeWarning,
        )
    raise CheckpointError(f"no complete checkpoint found under {directory!r}.")


def _iter_target(metric: Union[Metric, MetricCollection]) -> Iterator[Tuple[str, Metric]]:
    if isinstance(metric, MetricCollection):
        yield from metric.items()
    else:
        yield _SINGLE_KEY, metric


_FOLD_FX = ("sum", "cat", "max", "min")


def _fold_blockers(m: Metric) -> List[str]:
    """States whose reduction has no algebraic merge — ``merge_states``
    would raise mid-fold. Mirrors its dispatch: list/CatBuffer states always
    merge; plain leaves need ``fx`` in sum/max/min/cat. A metric overriding
    ``merge_states`` vouches for itself."""
    if type(m).merge_states is not Metric.merge_states:
        return []
    return [
        f"{name} (dist_reduce_fx={fx!r})"
        for name, fx in m._reductions.items()
        if not isinstance(m._defaults[name], (list, CatBuffer)) and fx not in _FOLD_FX
    ]


def _decoded_rows(value: Any) -> int:
    """Row count of one decoded (state_dict-format) cat-state value."""
    if isinstance(value, dict) and "__catbuffer__" in value:
        return int(value["count"])
    if isinstance(value, list):
        return int(sum(1 if x.ndim == 0 else x.shape[0] for x in value))
    return 1 if value.ndim == 0 else int(value.shape[0])


def _validate_fold(metric: Union[Metric, MetricCollection], shards: List[Dict[str, Any]]) -> None:
    """Scale-down fold pre-checks, run BEFORE any mutation so the
    all-or-nothing restore contract holds: every reduction must have an
    algebraic merge, and every target CatBuffer must have capacity for the
    assigned shards' combined rows."""
    paths = ", ".join(repr(s["path"]) for s in shards)
    for key, m in _iter_target(metric):
        blockers = _fold_blockers(m)
        if blockers:
            raise CheckpointError(
                f"elastic resume must fold {len(shards)} shards into "
                f"{type(m).__name__}, but state(s) {blockers} have no algebraic "
                "merge. Resume at the saved world size, or override "
                "`merge_states`."
            )
        for name in m._defaults:
            live = getattr(m, name)
            if not isinstance(live, CatBuffer):
                continue
            total = sum(_decoded_rows(s["states"][key][name]) for s in shards)
            if total > live.capacity:
                raise CheckpointError(
                    f"elastic resume would fold {total} rows into CatBuffer state "
                    f"{name!r} of {type(m).__name__} (capacity {live.capacity}) from "
                    f"shards {paths}. Scale-down concentrates data onto fewer "
                    "ranks — construct the metric with a larger `with_capacity`."
                )


def _target_dtype(m: Metric, name: str) -> Optional[torch.dtype]:
    """The dtype a state (or a cat state's rows) takes in the target, or None
    while a list state is empty (its rows keep the saved dtype)."""
    item = _declared_leaf_desc(m, name)["item"]
    return None if item is None else _resolve_dtype(item[0])


def _widened(value: Any, dtype: Optional[torch.dtype]) -> Any:
    """A decoded value with its integer leaves widened to ``dtype`` where
    the schema check allowed it."""
    if dtype is None:
        return value

    def cast(x: torch.Tensor) -> torch.Tensor:
        return x.to(dtype) if _widens(x.dtype, dtype) else x

    if isinstance(value, dict) and "__catbuffer__" in value:
        return {**value, "buffer": None if value["buffer"] is None else cast(value["buffer"])}
    if isinstance(value, list):
        return [cast(x) for x in value]
    return cast(value)


def _conformed(m: Metric, states: Dict[str, Any]) -> Dict[str, Any]:
    return {name: _widened(v, _target_dtype(m, name)) if name in m._defaults else v for name, v in states.items()}


def _after_restore(m: Metric, update_count: int) -> None:
    m._update_count = update_count
    if m._dtype is not None:
        m._restore(_cast_floating(m._state, m._dtype))


def _apply_replace(metric: Union[Metric, MetricCollection], shard: Dict[str, Any]) -> None:
    records = shard["manifest"]["metrics"]
    if isinstance(metric, MetricCollection):
        sd = {
            f"{key}.{name}": value
            for key, m in metric.items()
            for name, value in _conformed(m, shard["states"][key]).items()
        }
        metric.load_state_dict(sd, strict=True)
    else:
        metric.load_state_dict(_conformed(metric, shard["states"][_SINGLE_KEY]), strict=True)
    for key, m in _iter_target(metric):
        _after_restore(m, int(records[key].get("update_count", 0)))


def _apply_merge(metric: Union[Metric, MetricCollection], shard: Dict[str, Any]) -> None:
    records = shard["manifest"]["metrics"]
    for key, m in _iter_target(metric):
        live = {name: _sd_value_to_live(v, m.device) for name, v in _conformed(m, shard["states"][key]).items()}
        m.merge_state(live)
        _after_restore(m, m._update_count + int(records[key].get("update_count", 0)))


def load_checkpoint(
    metric: Union[Metric, MetricCollection],
    directory: str,
    *,
    step: Optional[int] = None,
    rank: Optional[int] = None,
    world: Optional[int] = None,
) -> Union[Metric, MetricCollection]:
    """Verified, elastic restore of a snapshot written by :func:`save_checkpoint`
    (of either package).

    ``step=None`` resumes the newest *complete* snapshot (steps a preemption
    left partially written are skipped). Every assigned shard file is fully
    verified — magic, manifest CRC, payload length, every leaf CRC — and
    schema-validated against the target *before any state is mutated*;
    corruption raises
    :class:`~metrics_tpu_torch.utils.exceptions.CheckpointCorruptError`,
    schema divergence :class:`~metrics_tpu_torch.utils.exceptions.StateSchemaError`.
    The restored leaves go to the metric's own device.

    **Elastic resume.** The snapshot's ``W`` shards restore into the current
    ``world`` = ``W'`` ranks (``rank``/``world`` default as in
    :func:`save_checkpoint`): this rank loads shard ``rank``, then folds
    shards ``rank + W'``, ``rank + 2·W'``, ... with ``merge_state``. A
    scale-up surplus rank (``rank >= W``) resets and starts accumulating
    fresh data. CatBuffer states must have capacity for the folded shards'
    combined rows.

    Returns ``metric`` with its accumulation resumed.
    """
    rank, world = _default_coordinates(rank, world)
    if world < 1 or not (0 <= rank < world):
        raise MetricsTPUUserError(
            f"load_checkpoint: invalid shard coordinates rank={rank}, world={world}"
        )
    for _key, m in _iter_target(metric):
        if m._is_synced:
            raise MetricsTPUUserError(
                f"load_checkpoint: {type(m).__name__} is currently synced — a later "
                "unsync() would clobber the restored state with the pre-sync cache. "
                "Call unsync() first."
            )
    snap_step, ckpt_world, shard_paths = _resolve_snapshot(directory, step)
    assigned = [i for i in range(ckpt_world) if i % world == rank]
    # verify + decode + schema-validate EVERY assigned shard before any mutation
    shards = [_decode_shard(shard_paths[i]) for i in assigned]
    for shard in shards:
        _validate_shard(metric, shard)
    if len(shards) > 1:
        _validate_fold(metric, shards)
    if not shards:
        # scale-up surplus rank: fresh defaults, fresh counters
        metric.reset()
    else:
        _apply_replace(metric, shards[0])
        for shard in shards[1:]:
            _apply_merge(metric, shard)
    registry_of(metric).inc("checkpoint", "loads")
    if journal.ACTIVE:
        # per-rank by design: elastic resume assigns each rank its own shard
        # stride, so the load event records this rank's fold
        journal.record(  # metricslint: disable=guarded-telemetry-emit
            "checkpoint.load", label=type(metric).__name__, step=snap_step, rank=rank, world=world,
            shards=len(shards), checkpoint_world=ckpt_world,
        )
    return metric


# ---------------------------------------------------------------------------
# auto-snapshot hook (Metric.checkpointer / MetricCollection.checkpointer)
# ---------------------------------------------------------------------------


class MetricCheckpointer:
    """Context manager: periodic atomic snapshots driven by ``update``/``forward``.

    Built by :meth:`Metric.checkpointer` / :meth:`MetricCollection.checkpointer`.
    While active, every ``every_n_updates``-th ``update`` (or ``forward``)
    calls :func:`save_checkpoint`. A clean exit flushes a final snapshot when
    updates happened since the last one; an exceptional exit leaves the last
    periodic snapshot as the resume point. Updates made while a CUDA graph is
    being captured never snapshot; the next one outside the capture does.

    Attributes:
        snapshots: shard paths written so far (newest last).
    """

    def __init__(
        self,
        metric: Union[Metric, MetricCollection],
        directory: str,
        *,
        every_n_updates: int = 1,
        keep_last: Optional[int] = None,
        rank: Optional[int] = None,
        world: Optional[int] = None,
    ) -> None:
        if int(every_n_updates) < 1:
            raise MetricsTPUUserError(
                f"every_n_updates must be >= 1, got {every_n_updates}"
            )
        self.metric = metric
        self.directory = directory
        self.every_n_updates = int(every_n_updates)
        self.keep_last = keep_last
        self.rank = rank
        self.world = world
        self.snapshots: List[str] = []
        self._pending = 0
        self._next_step = 0

    def __enter__(self) -> "MetricCheckpointer":
        if getattr(self.metric, "_auto_checkpointer", None) is not None:
            raise MetricsTPUUserError(
                "this metric already has an active checkpointer context; "
                "nesting them would double-snapshot every update."
            )
        # step numbering must be deterministic ACROSS ranks: seed from one
        # past the newest COMPLETE step, so a later-starting rank joins its
        # peers' partial steps instead of skipping past them
        complete = _complete_steps(self.directory)
        self._next_step = (complete[-1] + 1) if complete else 0
        self._pending = 0
        self.metric._auto_checkpointer = self
        return self

    def __exit__(self, exc_type: Any, exc: Any, tb: Any) -> None:
        self.metric._auto_checkpointer = None
        if exc_type is None and self._pending and not _capturing():
            if self._inflight_round():
                rank_zero_warn(
                    "checkpointer exiting with a non-blocking sync round in flight — the tail snapshot was "
                    "skipped (the live state holds only the post-snapshot delta). Resolve or cancel the "
                    "round, then call snapshot() for a final checkpoint.",
                    RuntimeWarning,
                )
                return
            self.snapshot()  # flush the tail on a clean exit

    def _inflight_round(self) -> bool:
        """Does a non-blocking sync round hold the accumulation?"""
        if isinstance(self.metric, MetricCollection):
            if self.metric.__dict__.get("_inflight_round") is not None:
                return True
            metrics = list(self.metric.values())
        else:
            metrics = [self.metric]
        return any(
            m.__dict__.get("_inflight") is not None or m.__dict__.get("_inflight_collection") is not None
            for m in metrics
        )

    def after_update(self, metric: Union[Metric, MetricCollection]) -> None:
        """Hook called by the stateful ``update``/``forward`` paths. While a
        non-blocking round holds the accumulation, a due snapshot waits: the
        first update after the round resolves takes it."""
        self._pending += 1
        if self._pending < self.every_n_updates or _capturing() or self._inflight_round():
            return
        self.snapshot()

    def snapshot(self) -> str:
        """Take one snapshot now (also the periodic/exit-flush path)."""
        registry_of(self.metric).inc("checkpoint", "auto_snapshots")
        path = save_checkpoint(
            self.metric,
            self.directory,
            step=self._next_step,
            rank=self.rank,
            world=self.world,
            keep_last=self.keep_last,
        )
        self._next_step += 1
        self._pending = 0
        self.snapshots.append(path)
        return path

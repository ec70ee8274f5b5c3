"""The 100-byte fixed-width record codec (paper §4/§5, Table 2).

Counterpart of ``repro/malgen/records.py`` (numpy only; the port keeps its
own copy). Layout (ASCII, 100 bytes exactly, newline-terminated so files
are also line-oriented like the paper's Hadoop Streams path):

    bytes  0-23   Event ID      "xxxxxxxx-sssssssssssssss"
                                (8 hex chars of the node-hostname hash, dash,
                                 15-digit per-node sequence — §5's "sequential
                                 and unique when restricted to a single node
                                 followed by a hash of the hostname")
    byte   24     '|'
    bytes  25-43  Timestamp     "YYYY-MM-DD HH:MM:SS" (19 chars)
    byte   44     '|'
    bytes  45-59  Site ID       15-digit zero-padded
    byte   60     '|'
    bytes  61-75  Entity ID     15-digit zero-padded
    byte   76     '|'
    byte   77     Mark          '0' or '1'
    bytes  78-98  padding (spaces)
    byte   99     '\\n'
"""

from __future__ import annotations

import numpy as np

RECORD_BYTES = 100
_EPOCH = np.datetime64("2010-01-01T00:00:00")  # benchmark year start


def encode_records(event_seq: np.ndarray, shard_hash: np.ndarray,
                   timestamp: np.ndarray, site_id: np.ndarray,
                   entity_id: np.ndarray, mark: np.ndarray) -> bytes:
    """Vectorized encode to a bytes blob of len N * 100."""
    n = len(site_id)
    buf = np.full((n, RECORD_BYTES), ord(" "), dtype=np.uint8)

    def put(col_start, strings, width):
        arr = np.frombuffer("".join(strings).encode("ascii"), dtype=np.uint8)
        buf[:, col_start:col_start + width] = arr.reshape(n, width)

    hashes = np.asarray(shard_hash, dtype=np.uint32)
    seqs = np.asarray(event_seq, dtype=np.uint64)
    put(0, [f"{h:08x}-{s:015d}" for h, s in zip(hashes, seqs)], 24)
    buf[:, 24] = ord("|")

    ts = _EPOCH + np.asarray(timestamp, dtype="timedelta64[s]")
    ts_str = np.datetime_as_string(ts, unit="s")  # "YYYY-MM-DDTHH:MM:SS"
    put(25, [s.replace("T", " ") for s in ts_str], 19)
    buf[:, 44] = ord("|")

    put(45, [f"{int(x):015d}" for x in site_id], 15)
    buf[:, 60] = ord("|")
    put(61, [f"{int(x):015d}" for x in entity_id], 15)
    buf[:, 76] = ord("|")
    put(77, [f"{int(x):1d}" for x in mark], 1)
    buf[:, 99] = ord("\n")
    return buf.tobytes()


def decode_records(blob: bytes):
    """Inverse of encode_records. Returns dict of numpy arrays."""
    n, rem = divmod(len(blob), RECORD_BYTES)
    if rem:
        raise ValueError(f"blob length {len(blob)} not a multiple of 100")
    buf = np.frombuffer(blob, dtype=np.uint8).reshape(n, RECORD_BYTES)

    def field(lo, hi):
        return buf[:, lo:hi].tobytes().decode("ascii")

    text = field(0, RECORD_BYTES)
    rows = [text[i * RECORD_BYTES:(i + 1) * RECORD_BYTES] for i in range(n)]
    shard_hash = np.array([int(r[0:8], 16) for r in rows], dtype=np.uint32)
    event_seq = np.array([int(r[9:24]) for r in rows], dtype=np.uint64)
    ts = np.array([np.datetime64(r[25:44].replace(" ", "T")) for r in rows])
    timestamp = (ts - _EPOCH).astype("timedelta64[s]").astype(np.int64)
    site_id = np.array([int(r[45:60]) for r in rows], dtype=np.int64)
    entity_id = np.array([int(r[61:76]) for r in rows], dtype=np.int64)
    mark = np.array([int(r[77]) for r in rows], dtype=np.int32)
    return dict(shard_hash=shard_hash, event_seq=event_seq,
                timestamp=timestamp, site_id=site_id, entity_id=entity_id,
                mark=mark)

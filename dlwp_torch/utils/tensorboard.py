"""Zero-dependency TensorBoard scalar event writer (own copy of
``dlwp_tpu.utils.tensorboard``, the same bytes for the same events).

It hand-encodes ``Event`` protobufs (wall_time, step,
``Summary.Value{tag, simple_value}``) into the TFRecord framing TensorBoard
reads (length + masked CRC32C records), without TensorFlow or the
tensorboard package.

Use :class:`TensorBoardWriter` directly, pass it as an epoch callback to
``Trainer.fit``, or wrap it in :class:`dlwp_torch.train.callbacks.RunHistory`
(it implements the ``log(key, value)`` run protocol with an internal step
counter).
"""

from __future__ import annotations

import os
import socket
import struct
import time

# ---------------------------------------------------------------- CRC32C
# Castagnoli polynomial (reflected), required by the TFRecord framing.
_CRC_TABLE = []
for _n in range(256):
    _c = _n
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------------- protobuf
def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _bytes_field(field: int, data: bytes) -> bytes:
    return _key(field, 2) + _varint(len(data)) + data


def _double_field(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _float_field(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _int64_field(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _scalar_event(tag: str, value: float, step: int, wall_time: float) -> bytes:
    # Summary.Value { tag = 1: string, simple_value = 2: float }
    val = _bytes_field(1, tag.encode("utf-8")) + _float_field(2, float(value))
    summary = _bytes_field(1, val)  # Summary { value = 1: repeated }
    # Event { wall_time = 1: double, step = 2: int64, summary = 5: message }
    return (
        _double_field(1, wall_time)
        + _int64_field(2, int(step))
        + _bytes_field(5, summary)
    )


def _version_event(wall_time: float) -> bytes:
    # Event { wall_time = 1, file_version = 3: string }
    return _double_field(1, wall_time) + _bytes_field(3, b"brain.Event:2")


class TensorBoardWriter:
    """Write scalar curves to a TensorBoard event file.

    Args:
        logdir: directory for the ``events.out.tfevents.*`` file (created
            if missing). Point ``tensorboard --logdir`` at it.
        filename_suffix: optional suffix distinguishing concurrent writers.

    Usable three ways::

        tb = TensorBoardWriter(logdir)
        tb.scalar("loss", 0.5, step=3)          # direct
        trainer.fit(..., callbacks=[tb])        # epoch callback
        RunHistory(tb)                          # run protocol (log())
    """

    def __init__(self, logdir: str, filename_suffix: str = ""):
        os.makedirs(logdir, exist_ok=True)
        name = "events.out.tfevents.%010d.%s%s" % (
            int(time.time()),
            socket.gethostname(),
            filename_suffix,
        )
        self.path = os.path.join(logdir, name)
        self._file = open(self.path, "ab")
        self._steps: dict[str, int] = {}
        self._write(_version_event(time.time()))
        self.flush()

    # ------------------------------------------------------------ records
    def _write(self, event: bytes) -> None:
        header = struct.pack("<Q", len(event))
        self._file.write(header)
        self._file.write(struct.pack("<I", _masked_crc(header)))
        self._file.write(event)
        self._file.write(struct.pack("<I", _masked_crc(event)))

    def scalar(self, tag: str, value, step: int, wall_time=None) -> None:
        """Record one scalar point on the curve ``tag``."""
        self._write(
            _scalar_event(
                tag, value, step,
                time.time() if wall_time is None else wall_time,
            )
        )

    # -------------------------------------------------- callback protocols
    def __call__(self, epoch: int, metrics: dict, params=None) -> None:
        """Epoch-callback protocol (``Trainer.fit`` callbacks list)."""
        for k, v in metrics.items():
            self.scalar(k, v, epoch)
        self.flush()

    def log(self, key: str, value) -> None:
        """Run protocol (``RunHistory``): auto-incrementing step per key."""
        step = self._steps.get(key, 0)
        self._steps[key] = step + 1
        self.scalar(key, value, step)

    # ----------------------------------------------------------- lifecycle
    def flush(self) -> None:
        self._file.flush()

    def close(self) -> None:
        if not self._file.closed:
            self._file.flush()
            self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


__all__ = ["TensorBoardWriter", "crc32c"]

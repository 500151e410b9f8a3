"""Host-side video decode and frame streaming (a copy of
`kalman_hydra_tpu/io/video.py`, with `device_prefetch` on CUDA streams).

Decode stays on the host (codecs are CPU work); `device_prefetch` owns the
one host -> card crossing a frame takes. OpenCV is used only as a codec
here, never for compute, and only where a codec is needed: `.npz`/`.npy`
clips stream without it.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch


def open_video(path: str) -> "FrameStream":
    return FrameStream(path)


class FrameStream:
    """Iterates BGR uint8 frames from a video file (or .npz/.npy clip).

    gray=True yields (H, W) uint8 via cv2.cvtColor (bit-identical to the
    device grayscale): 1/3 of the host -> card bytes in streaming mode."""

    def __init__(self, path: str, gray: bool = False):
        self.path = path
        self.gray = bool(gray)
        self._cap = None
        self._arr = None
        if path.endswith((".npz", ".npy")):
            if path.endswith(".npz"):
                with np.load(path) as z:
                    self._arr = z[list(z.keys())[0]]
            else:
                self._arr = np.load(path)
            self.num_frames = len(self._arr)
            self.height, self.width = self._arr[0].shape[:2]
            self.fps = 30.0
        else:
            import cv2  # codec only
            self._cap = cv2.VideoCapture(path)
            if not self._cap.isOpened():
                raise IOError(f"cannot open video {path!r}")
            self.num_frames = int(self._cap.get(cv2.CAP_PROP_FRAME_COUNT))
            self.width = int(self._cap.get(cv2.CAP_PROP_FRAME_WIDTH))
            self.height = int(self._cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
            self.fps = float(self._cap.get(cv2.CAP_PROP_FPS)) or 30.0

    def __iter__(self) -> Iterator[np.ndarray]:
        if self.gray:
            import cv2
        if self._arr is not None:
            for f in self._arr:
                f = np.ascontiguousarray(f)
                if self.gray and f.ndim == 3 and f.shape[-1] == 3:
                    f = cv2.cvtColor(f, cv2.COLOR_BGR2GRAY)
                yield f
            return
        while True:
            ok, frame = self._cap.read()
            if not ok:
                break
            if self.gray:
                frame = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
            yield frame

    def read_all(self, limit: Optional[int] = None) -> np.ndarray:
        """Decode the whole clip to one (T, H, W[, C]) array."""
        out = []
        for i, f in enumerate(self):
            if limit is not None and i >= limit:
                break
            out.append(f)
        return np.stack(out)

    def close(self):
        if self._cap is not None:
            self._cap.release()
            self._cap = None


class _Relay:
    """A bounded queue from one worker thread to one consumer. A put gives
    up once the consumer has stopped, so an abandoned consumer cannot pin
    the worker (and what it holds: an open decoder, pinned buffers, frames
    on the card) for the life of the process."""

    END = object()

    def __init__(self, depth: int):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
        self.stop = threading.Event()

    def put(self, item) -> bool:
        while not self.stop.is_set():
            try:
                self._q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def run(self, produce) -> None:
        """The worker's body: put what `produce()` yields, then END; an
        exception is relayed to the consumer, so a decode error never
        reads as a clean end of stream."""
        try:
            for item in produce():
                if not self.put(item):
                    return
            self.put(self.END)
        except BaseException as e:  # noqa: BLE001 - relayed to consumer
            self.put(e)

    def __iter__(self):
        try:
            while True:
                item = self._q.get()
                if item is self.END:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # on exhaustion and on abandonment (GeneratorExit) alike: stop
            # the worker, and free one slot so a blocked put wakes up
            self.stop.set()
            try:
                self._q.get_nowait()
            except queue.Empty:
                pass


class PrefetchStream:
    """Background-thread decode with a bounded queue: the consumer pulls
    frame t while the worker decodes t+1..t+depth. A decode error reaches
    the consumer."""

    def __init__(self, stream, depth: int = 4):
        self._relay = _Relay(depth)
        self._thread = threading.Thread(
            target=self._relay.run, args=(lambda: iter(stream),),
            daemon=True)
        self._thread.start()

    def __iter__(self):
        return iter(self._relay)


def device_prefetch(frames, depth: int = 2, *, device="cuda"):
    """Iterator of frames as tensors on `device`, with decode and the
    host -> card copy of the next frames overlapped with the consumer's
    compute.

    On the card a worker thread copies each frame into one of a ring of
    pinned host buffers, issues a non-blocking copy to the card on a side
    CUDA stream and records an event; the consumer's current stream waits
    on that event before the frame is used. A pinned buffer is refilled
    only once the copy out of it has finished (one event a slot), and
    each frame is marked as used on the consumer's stream
    (`record_stream`), so the caching allocator cannot hand its memory
    out again while the consumer's work still reads it. With
    device="cpu" it yields CPU tensors. Asked for "cuda" without a card
    it raises; it never falls back to the CPU. Exceptions in the worker
    reach the consumer."""
    dev = torch.device(device)
    if dev.type == "cuda":
        from .. import cuda_device
        dev = cuda_device(dev.index or 0)  # raises without a card
        produce = _card_frames(frames, depth, dev)
    else:
        def produce():
            for f in frames:
                yield torch.from_numpy(np.ascontiguousarray(f))
    relay = _Relay(depth)
    threading.Thread(target=relay.run, args=(produce,), daemon=True).start()
    return _consume(relay, dev)


def _consume(relay: _Relay, dev: torch.device):
    for item in relay:
        if dev.type != "cuda":
            yield item
            continue
        frame, ready = item
        stream = torch.cuda.current_stream(dev)
        stream.wait_event(ready)
        frame.record_stream(stream)
        yield frame


def _card_frames(frames, depth: int, dev: torch.device):
    """The worker's side of `device_prefetch` on the card: yields (frame
    on the card, event recorded after its copy)."""

    def produce():
        torch.cuda.set_device(dev)       # the worker thread's own device
        side = torch.cuda.Stream(dev)
        # (pinned buffer, event after its last copy out): depth frames may
        # sit in the queue, one in the consumer's hands and one being
        # filled, so a slot comes round again after depth + 2 frames
        slots = [None] * (depth + 2)
        for i, f in enumerate(frames):
            src = torch.from_numpy(np.ascontiguousarray(f))
            j = i % len(slots)
            host = None
            if slots[j] is not None:
                host, done = slots[j]
                done.synchronize()
                if host.shape != src.shape or host.dtype != src.dtype:
                    host = None
            if host is None:
                host = torch.empty_like(src, pin_memory=True)
            host.copy_(src)
            with torch.cuda.stream(side):
                frame = host.to(dev, non_blocking=True)
            done = torch.cuda.Event()
            done.record(side)
            slots[j] = (host, done)
            yield frame, done

    return produce


def write_video(path: str, frames: np.ndarray, fps: float = 30.0) -> None:
    """Write (T, H, W, 3) BGR uint8 frames (debug overlays; host,
    post-hoc); .npz writes the array itself."""
    if path.endswith(".npz"):
        np.savez_compressed(path, frames=frames)
        return
    import cv2
    h, w = frames.shape[1:3]
    fourcc = cv2.VideoWriter_fourcc(*"mp4v")
    wr = cv2.VideoWriter(path, fourcc, fps, (w, h))
    try:
        for f in frames:
            wr.write(np.ascontiguousarray(f))
    finally:
        wr.release()

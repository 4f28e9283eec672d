"""Host-side video ingest: decode + the reference's resize rule, in memory.

The reference decodes with cv2.VideoCapture and round-trips EVERY frame
through a jpg on disk (reference lib/utils/funcs_utils.py:18-53,
SURVEY.md flags the jpg round-trip as a key bottleneck). Here frames stay in
one contiguous RGB ndarray feeding device batches directly; an optional
dump writes the reference-format '%09d.jpg' tree for debugging parity.

Resize rule parity (funcs_utils.py:26-31): if width > 800 scale to 800 wide,
elif height > 450 scale to 450 tall; always resize (even when unchanged).

Own copy of the JAX package's io/video.py, plus the windowed decode stream
(_decode_windows / _window_stream) that the Predictor's overlapped
ingest consumes.
"""

from __future__ import annotations

import os
import os.path as osp
import queue
import threading
from dataclasses import dataclass
from typing import List, Optional

import numpy as np


def reference_resize_dims(width: int, height: int) -> tuple[int, int]:
    if width > 800:
        height = int(height * 800 / width)
        width = 800
    elif height > 450:
        width = int(width * 450 / height)
        height = 450
    return width, height


@dataclass
class VideoClip:
    frames: np.ndarray  # (N, H, W, 3) uint8 RGB
    fps: float

    @property
    def num_frames(self) -> int:
        return int(self.frames.shape[0])


def _resize_rgb(bgr: np.ndarray, width: int, height: int) -> np.ndarray:
    """THE pixel pipeline: cv2.resize then BGR->RGB, in that order (the
    reference's funcs_utils.py:34-41 order). Every decoder in this module --
    serial, parallel segment workers, and the streaming lookahead thread --
    must route through this one function so the pixels cannot fork."""
    import cv2

    return cv2.cvtColor(cv2.resize(bgr, (width, height)), cv2.COLOR_BGR2RGB)


def _decoded_rgb(cap, width: int, height: int, start_idx: int = 0,
                 max_frames: int | None = None):
    """Yield (global_idx, resized RGB frame) from cap's current position.

    THE decode loop: read_video, the streaming lookahead thread, and the
    parallel decoder's serial fallback all consume it."""
    idx = start_idx
    while max_frames is None or idx < max_frames:
        ret, bgr = cap.read()
        if not ret:
            return
        yield idx, _resize_rgb(bgr, width, height)
        idx += 1


def _bounded_put(q, item, stop) -> bool:
    """put() on a bounded queue that aborts when `stop` is set, so a decode
    thread abandoned by its consumer releases instead of blocking forever on
    the full queue. Returns False when aborted."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            continue
    return False


def _open_video(path: str):
    """(cap, fps, out_width, out_height) with the resize rule applied;
    raises FileNotFoundError when the container cannot be opened. Shared
    prologue of every decoder in this module."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video: {path}")
    fps = float(cap.get(cv2.CAP_PROP_FPS))
    width, height = reference_resize_dims(
        int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
        int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)))
    return cap, fps, width, height


def read_video(path: str, max_frames: int | None = None) -> VideoClip:
    """Decode a video to in-memory RGB frames with the reference resize rule."""
    cap, fps, width, height = _open_video(path)
    frames = [rgb for _, rgb in _decoded_rgb(cap, width, height,
                                             max_frames=max_frames)]
    cap.release()
    if not frames:
        raise ValueError(f"video decoded to zero frames: {path}")
    return VideoClip(frames=np.stack(frames), fps=float(fps))


def iter_windows_parallel(path: str, window: int, workers: int,
                          max_frames: int | None = None):
    """Window generator decoding with `workers` threads, serial-exact output.

    The reference parallelised its CROP loading with torch DataLoader
    workers (lib/core/config.py:31, base.py:123) but decoded video serially
    (funcs_utils.py:18-53). Here the frame range splits into `workers`
    contiguous window-aligned SEGMENTS; each worker owns a VideoCapture,
    seeks to its segment (cv2 releases the GIL inside read/resize, so
    threads scale across cores) and decodes windows into a bounded queue,
    which the consumer drains in global order -- peak buffered memory is
    O(workers * window) frames.

    Yields exactly the serial protocol: ("meta", fps), then
    ("window", start_idx, frames) in order, then ("end", total_frames) --
    including ("end", 0) for an openable but frameless file, exactly like
    the serial stream (callers decide whether that is an error).

    Container seek is NOT trusted. A worker with a nonzero segment start
    also decodes the (up to) TWO guard frames just before its segment, and
    the consumer compares them byte-exactly against the previous segment's
    last frames BEFORE yielding any of the segment's windows; the backend
    must additionally REPORT the requested landing position. The tail
    worker ignores the (often wrong) CAP_PROP_FRAME_COUNT and reads to EOF.
    On any guard mismatch, seek failure, or mid-segment short read, decode
    falls back to a serial capture that grab()-skips the frames already
    yielded and continues -- so the yielded stream is bit-identical to
    read_video's frames (residual assumption: a backend that BOTH echoes
    the requested landing position without honouring it AND lands where
    both guard frames happen to be byte-identical to the true ones would
    escape the check; the JAX package's docs/PARITY.md #6), just possibly slower."""
    import cv2

    cap, fps, width, height = _open_video(path)
    n_total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()

    n = n_total if max_frames is None else min(n_total, max_frames)
    n_windows = max(1, -(-n // window))
    if workers > 1 and n_total <= 0:
        # Stream-copied webm/mkv can report no frame count; segmentation
        # needs one, so decode runs serially -- say so rather than silently
        # dropping the advertised speedup on the production bottleneck.
        import warnings

        warnings.warn(
            f"{path} reports no frame count (CAP_PROP_FRAME_COUNT="
            f"{n_total}); parallel decode disabled, falling back to one "
            "decode thread", RuntimeWarning, stacklevel=2)
    workers = max(1, min(workers, n_windows // 2))  # >=2 windows per worker

    # Window-aligned segment bounds in frame indices; the tail segment is
    # open-ended (reads to EOF / max_frames) so an undercounting
    # CAP_PROP_FRAME_COUNT can never drop trailing frames.
    wbounds = np.linspace(0, n_windows, workers + 1).round().astype(int)
    bounds = [int(b) * window for b in wbounds]

    stop = threading.Event()
    queues = [queue.Queue(maxsize=2) for _ in range(workers)]

    def decode_segment(w: int) -> None:
        start = bounds[w]
        end = None if w == workers - 1 else bounds[w + 1]
        q = queues[w]

        def emit(item) -> bool:
            return _bounded_put(q, item, stop)

        # Any exception must surface as a "fail" item -- including one from
        # the VideoCapture constructor itself: the consumer blocks on this
        # queue with no timeout, so a silently dead worker would deadlock
        # the stream.
        c = None
        try:
            c = cv2.VideoCapture(path)
            if not c.isOpened():
                emit(("fail", "open failed"))
                return
            gcount = min(2, start)
            first = start - gcount
            if first > 0:
                if not c.set(cv2.CAP_PROP_POS_FRAMES, first):
                    emit(("fail", "seek failed"))
                    return
                # A guard-frame content check alone can false-pass when
                # adjacent frames are byte-identical (static scenes decode
                # to identical pixels), so also require the backend to
                # REPORT the requested landing position.
                landed = int(round(c.get(cv2.CAP_PROP_POS_FRAMES)))
                if landed != first:
                    emit(("fail", f"seek landed at {landed}, not {first}"))
                    return
            guards: list[np.ndarray] = []
            for gidx in range(gcount):
                ret, bgr = c.read()
                if not ret:
                    # The seek silently landed at/near EOF (or the file
                    # shrank); the serial fallback proves whether frames
                    # actually remained.
                    emit(("fail", f"short read in guard at frame {first + gidx}"))
                    return
                guards.append(_resize_rgb(bgr, width, height))
            if guards and not emit(("guard", np.stack(guards))):
                return
            buf: list[np.ndarray] = []
            idx = start
            while not stop.is_set():
                if end is not None and idx >= end:
                    break
                if end is None and max_frames is not None and idx >= max_frames:
                    break
                ret, bgr = c.read()
                if not ret:
                    if end is not None:
                        # Mid-segment short read: either the container lied
                        # about its length or the seek landed late. The
                        # consumer re-decodes serially from its position.
                        emit(("fail", f"short read at frame {idx}"))
                        return
                    break  # tail segment: genuine EOF
                buf.append(_resize_rgb(bgr, width, height))
                idx += 1
                if len(buf) == window:
                    if not emit(("window", idx - window, np.stack(buf))):
                        return
                    buf = []
            if buf and not stop.is_set():
                if not emit(("window", idx - len(buf), np.stack(buf))):
                    return
            emit(("done", idx))
        except Exception as exc:  # pragma: no cover - defensive
            emit(("fail", repr(exc)))
        finally:
            if c is not None:
                c.release()

    threads = [threading.Thread(target=decode_segment, args=(w,), daemon=True)
               for w in range(workers)]
    for t in threads:
        t.start()

    def serial_tail(consumed: int):
        """Integrity fallback: re-decode serially, grab()-skipping the
        `consumed` frames already yielded (those were guard-verified)."""
        import warnings

        warnings.warn(
            f"parallel decode integrity check failed for {path} "
            "(inaccurate container seek or frame count); continuing with "
            "serial decode", RuntimeWarning, stacklevel=2)
        c = cv2.VideoCapture(path)
        try:
            for _ in range(consumed):
                if not c.grab():
                    raise RuntimeError(
                        f"serial fallback lost frames in {path}: the file "
                        f"shrank below the {consumed} frames already decoded")
            buf: list[np.ndarray] = []
            total = consumed
            for idx, rgb in _decoded_rgb(c, width, height, start_idx=consumed,
                                         max_frames=max_frames):
                buf.append(rgb)
                total = idx + 1
                if len(buf) == window:
                    yield ("window", total - window, np.stack(buf))
                    buf = []
            if buf:
                yield ("window", total - len(buf), np.stack(buf))
            yield ("end", total)
        finally:
            c.release()

    try:
        yield ("meta", fps)
        consumed = 0
        # Rolling tail of the last two yielded frames (may span windows):
        # each segment's guard frames must match these byte-exactly, which
        # anchors every seek transitively back to worker 0's seek-free
        # decode from frame 0.
        tail: list[np.ndarray] = []
        for w in range(workers):
            # A segment's windows are yielded only after its seek is proven:
            # the guard frames must arrive first and match the previous
            # segment's last frames byte-exactly. A segment that finishes
            # without ever producing its guard (seek silently landed at EOF)
            # is treated as failed too -- the serial fallback then proves
            # whether frames actually remained.
            expect_guard = bounds[w] > 0
            failed = False
            while True:
                kind, *rest = queues[w].get()
                if kind == "fail":
                    failed = True
                    break
                if kind == "guard":
                    guards = rest[0]
                    if (not expect_guard or len(tail) < len(guards)
                            or not all(np.array_equal(g, t) for g, t in
                                       zip(guards, tail[-len(guards):]))):
                        failed = True
                        break
                    expect_guard = False
                    continue
                if kind == "done":
                    failed = expect_guard
                    break
                start_idx, frames = rest
                if expect_guard or start_idx != consumed:
                    failed = True
                    break
                tail = [np.asarray(f) for f in frames[-2:]] \
                    if len(frames) >= 2 else (tail + [np.asarray(frames[-1])])[-2:]
                consumed = start_idx + len(frames)
                yield ("window", start_idx, frames)
            if failed:
                stop.set()
                yield from serial_tail(consumed)
                return
        yield ("end", consumed)
    finally:
        stop.set()


def read_video_parallel(
    path: str, workers: int, max_frames: int | None = None,
    window: int = 256,
) -> VideoClip:
    """Whole-clip wrapper over iter_windows_parallel: decode with `workers`
    threads, bit-identical frames to read_video (integrity-guarded seek with
    automatic serial fallback -- see iter_windows_parallel)."""
    if workers <= 1:
        return read_video(path, max_frames)
    fps = 0.0
    pieces = []
    for item in iter_windows_parallel(path, window, workers, max_frames):
        if item[0] == "meta":
            fps = item[1]
        elif item[0] == "window":
            pieces.append(item[2])
    if not pieces:
        raise ValueError(f"video decoded to zero frames: {path}")
    return VideoClip(frames=np.concatenate(pieces), fps=fps)


def _subsample(frames: np.ndarray, n: int) -> np.ndarray:
    """At most n frames drawn evenly (first and last included)."""
    if len(frames) <= n:
        return frames
    idx = np.linspace(0, len(frames) - 1, n).round().astype(np.int64)
    return frames[idx]


def load_calibration_frames(path: str, n: int = 64) -> np.ndarray:
    """Representative frames for int8 PTQ calibration (DETECTOR.calibration):

      * a .npy/.npz of (N, H, W, 3) uint8 RGB frames (the first array of an
        npz), drawn evenly down to n;
      * a directory of images (jpg/jpeg/png/bmp, sorted by name, the first
        n), each resized by the reference rule so the canvas geometry
        matches the detector's ingest;
      * a video, decoded with the reference resize rule and drawn evenly
        down to n.

    Returns (n', H, W, 3) uint8 RGB. Raises on empty, float or unreadable
    sources: a silent mis-calibration is worse than a crash."""
    if path.endswith((".npy", ".npz")):
        data = np.load(path)
        frames = np.asarray(data[data.files[0]] if hasattr(data, "files") else data)
        if frames.ndim != 4 or frames.shape[-1] != 3:
            raise ValueError(f"calibration array must be (N, H, W, 3), got {frames.shape}")
        if frames.dtype != np.uint8:
            # astype(uint8) on [0, 1] floats would truncate every pixel to 0
            # and calibrate on black.
            raise ValueError(
                "calibration array must be uint8 RGB (0..255), got "
                f"{frames.dtype}; convert explicitly (e.g. "
                "np.clip(x*255, 0, 255).astype(np.uint8) for [0,1] floats)")
        return _subsample(frames, n)
    if osp.isdir(path):
        import cv2

        names = sorted(f for f in os.listdir(path)
                       if f.lower().endswith((".jpg", ".jpeg", ".png", ".bmp")))[:n]
        if not names:
            raise ValueError(f"no images found in calibration dir: {path}")
        frames = []
        for name in names:
            bgr = cv2.imread(osp.join(path, name))
            if bgr is None:
                raise ValueError(f"unreadable calibration image: {name}")
            w, h = reference_resize_dims(bgr.shape[1], bgr.shape[0])
            frames.append(_resize_rgb(bgr, w, h))
        shapes = {f.shape for f in frames}
        if len(shapes) > 1:
            raise ValueError(f"calibration images resize to mixed shapes: {sorted(shapes)}")
        return np.stack(frames)
    return _subsample(read_video(path).frames, n)


def dump_frames(clip: VideoClip, tmp_path: str) -> int:
    """Write the reference-format '%09d.jpg' frame tree (debug parity only)."""
    import cv2

    os.makedirs(tmp_path, exist_ok=True)
    for idx, frame in enumerate(clip.frames):
        cv2.imwrite(
            osp.join(tmp_path, "{0:09d}.jpg".format(idx)),
            cv2.cvtColor(frame, cv2.COLOR_RGB2BGR),
        )
    return clip.num_frames


def jpeg_roundtrip(clip: VideoClip, tmp_path: str | None = None) -> VideoClip:
    """Round-trip every frame through JPEG, exactly as the reference computes.

    The reference writes each decoded frame to '{output}/tmp/%09d.jpg'
    (reference lib/utils/funcs_utils.py:42, cv2.imwrite defaults =
    quality 95) and re-reads the jpgs for BOTH detection and cropping
    (demo_dataset.py:59), so its SPIN inputs carry JPEG artifacts. This
    parity mode reproduces that: with tmp_path the frames take the identical
    disk route (written '%09d.jpg', read back, caller removes the tree like
    base.py:184); without it cv2.imencode/imdecode produce the same pixels
    in memory. Enabled via DatasetConfig.jpeg_ingest."""
    import cv2

    out = np.empty_like(clip.frames)
    if tmp_path is not None:
        n = dump_frames(clip, tmp_path)
        for idx in range(n):
            bgr = cv2.imread(osp.join(tmp_path, "{0:09d}.jpg".format(idx)))
            out[idx] = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
    else:
        for idx, frame in enumerate(clip.frames):
            ok, buf = cv2.imencode(".jpg", cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
            if not ok:
                raise RuntimeError(f"jpeg encode failed for frame {idx}")
            out[idx] = cv2.cvtColor(cv2.imdecode(buf, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
    return VideoClip(frames=out, fps=clip.fps)


def write_video(frames_bgr, fps: float, file_path: str) -> None:
    """mp4 writer with the reference's fourcc (0x7634706d, base.py:301)."""
    import cv2

    h, w = frames_bgr[0].shape[0], frames_bgr[0].shape[1]
    writer = cv2.VideoWriter(file_path, 0x7634706D, fps, (w, h))
    for frame in frames_bgr:
        writer.write(np.uint8(frame))
    writer.release()


def _decode_windows(path: str, window: int, out_q: "queue.Queue",
                    max_frames: Optional[int], stop: "threading.Event"):
    """Background thread: decode + resize-rule, emit (start_idx, frames)
    windows through the shared pixel pipeline (_decoded_rgb) and bounded put,
    so an abandoned consumer releases the thread, the VideoCapture handle
    and the buffered windows instead of blocking forever on the full queue.
    Every failure surfaces as an ("error", kind, msg) item: a thread that
    died silently would leave the consumer blocked on q.get()."""

    def emit(item) -> bool:
        return _bounded_put(out_q, item, stop)

    try:
        cap, fps, width, height = _open_video(path)
    except FileNotFoundError:
        emit(("error", "not_found", f"cannot open video: {path}"))
        return
    except Exception as exc:
        emit(("error", "setup", f"decode setup failed for {path}: {exc!r}"))
        return
    if not emit(("meta", fps)):
        cap.release()
        return

    buf: List[np.ndarray] = []
    idx = 0
    try:
        for idx_, rgb in _decoded_rgb(cap, width, height,
                                      max_frames=max_frames):
            if stop.is_set():
                return
            buf.append(rgb)
            idx = idx_ + 1
            if len(buf) == window:
                if not emit(("window", idx - window, np.stack(buf))):
                    return
                buf = []
        if buf:
            emit(("window", idx - len(buf), np.stack(buf)))
    except Exception as exc:
        # A mid-clip decode failure must not masquerade as a clean EOF.
        emit(("error", "decode", f"decode failed after frame {idx}: {exc!r}"))
        return
    finally:
        cap.release()
    emit(("end", idx))


def _window_stream(video_path: str, window: int, max_frames: Optional[int],
                   workers: int = 1):
    """Generator over decoded windows with a one-window-lookahead thread.

    Yields ("meta", fps) | ("window", start_idx, frames) | ("end", total).
    workers > 1 decodes with that many capture threads over window-aligned
    segments (iter_windows_parallel): same protocol, serial-exact frames."""
    if workers > 1:
        yield from iter_windows_parallel(video_path, window, workers,
                                         max_frames)
        return
    q: "queue.Queue" = queue.Queue(maxsize=2)  # 1 window in flight + 1 ready
    stop = threading.Event()
    thread = threading.Thread(
        target=_decode_windows, args=(video_path, window, q, max_frames, stop),
        daemon=True,
    )
    thread.start()
    try:
        while True:
            item = q.get()
            if item[0] == "error":
                _, kind, msg = item
                if kind == "not_found":
                    raise FileNotFoundError(msg)
                raise RuntimeError(msg)
            yield item
            if item[0] == "end":
                break
    finally:
        stop.set()
        thread.join(timeout=5)

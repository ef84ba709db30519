"""Streaming file-fed odometry: IO / upload / compute pipelined.

The reference's usage model is a serial file loop (``README.md:44-60``:
read scan -> extractFeatures -> registerFeatures -> compose). Run as
written, reading, uploading and computing are three serialized stages.
This driver overlaps them:

  1. the native prefetch loader (``io/native/loam_io.cpp``) reads + projects
     + PACKS scans in worker threads, ahead of the consumer;
  2. scans optionally cross to the device in the 4-byte/point packed
     format (``io/packed.py``) — 3x fewer bytes, sub-sensor-noise
     quantization;
  3. frames are uploaded and computed in CHUNKS: ``jax.device_put`` and the
     jitted chunk step are both async, so chunk c's upload/compute overlap
     chunk c+1's host-side IO — no barrier until the trajectory is read.

Each chunk registers its K frames against their predecessors in one
lockstep vmapped solve, carrying the previous chunk's boundary features
(so no frame is extracted twice) and its last relative pose (the same
constant-velocity prior ``odometry_offline(motion_init=True)`` uses).
The very first pair registers frame 0 against an EMPTY feature set, which
terminates with INSUFFICIENT_ASSOCIATIONS at its identity init (SURVEY
§2.3(9)) — exactly the reference's "first scan just initializes" behavior
with no special casing.
"""

from __future__ import annotations

import functools
from typing import Iterable, NamedTuple, Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..features import FeatureSet
from ..features.extract import extract_features_batch
from ..geometry import Pose3, pose_cumcompose
from ..params import FeatureExtractionParams, LidarParams, RegistrationParams
from ..registration import RegistrationDetail
from ..registration.icf import _register
from .scan_to_scan import scan_to_scan_init


class StreamCarry(NamedTuple):
    """Device-resident carry between chunk steps (a pytree)."""

    prev_feats: FeatureSet  # features of the last frame seen
    prev_delta: Pose3       # its converged relative pose (motion prior)
    world: Pose3            # world_T_last_frame


def stream_init(
    lidar: LidarParams,
    feat_params: FeatureExtractionParams = FeatureExtractionParams(),
    dtype=jnp.float32,
) -> StreamCarry:
    s = scan_to_scan_init(lidar, feat_params, dtype)
    return StreamCarry(
        prev_feats=s.prev_features,
        prev_delta=s.prev_delta,
        world=s.world_T_current,
    )


@functools.partial(
    jax.jit,
    static_argnames=("lidar", "feat_params", "reg_params", "packed_cfg",
                     "motion_init", "dewarp"),
)
def stream_chunk_step(
    carry: StreamCarry,
    chunk: jax.Array,
    lidar: LidarParams,
    feat_params: FeatureExtractionParams = FeatureExtractionParams(),
    reg_params: RegistrationParams = RegistrationParams(),
    packed_cfg: Optional[Tuple[float, float, float]] = None,
    motion_init: bool = True,
    dewarp: bool = False,
) -> Tuple[StreamCarry, Pose3, RegistrationDetail]:
    """Process K frames: extract, register each against its predecessor.

    Args:
      chunk: (K, L, P, 3) f32 scans, or (K, 4, L, P) u8 packed planes when
        ``packed_cfg`` is set.
      packed_cfg: (elev_lo, elev_hi, r_max) of the packed wire format; the
        decode is elementwise and fuses into the extraction program.

    Returns (new_carry, world (K,) Pose3 for these frames, detail (K,)).
    Pair j registers frame j against frame j-1 (the carry's boundary
    features for j=0), all K in lockstep — the same math as
    ``odometry_offline``'s chunked form, reshaped for a stream.
    """
    if packed_cfg is not None:
        from ..io.packed import decode_packed

        elev_lo, elev_hi, r_max = packed_cfg
        scans = decode_packed(chunk, elev_lo, elev_hi, r_max)
    else:
        scans = chunk
    K = scans.shape[0]
    if dewarp:
        # constant-velocity motion compensation with the carried previous
        # relative pose — the same prior scan_to_scan_step(dewarp=True)
        # uses, applied to every frame of the chunk in lockstep
        from ..dewarp import dewarp_scan

        scans = jax.vmap(
            lambda sc: dewarp_scan(sc, carry.prev_delta, lidar)
        )(scans)
    feats = extract_features_batch(scans, lidar, feat_params)
    dtype = feats.edge_points.dtype
    tgt = jax.tree.map(
        lambda prev, f: jnp.concatenate([prev[None], f[:-1]], axis=0),
        carry.prev_feats,
        feats,
    )
    if motion_init:
        init = jax.tree.map(
            lambda x: jnp.broadcast_to(x, (K,) + x.shape), carry.prev_delta
        )
    else:
        init = Pose3.identity(dtype, (K,))
    rel, det = jax.vmap(
        lambda s_, t_, i_: _register(
            s_, t_, i_, reg_params, with_matches=False
        )
    )(feats, tgt, init)
    # world_T_frame_j = carry.world o rel_0 o ... o rel_j
    cum = pose_cumcompose(rel)
    world = jax.vmap(lambda c: carry.world.compose(c))(cum)
    new_carry = StreamCarry(
        prev_feats=jax.tree.map(lambda x: x[-1], feats),
        prev_delta=jax.tree.map(lambda x: x[-1], rel),
        world=jax.tree.map(lambda x: x[-1], world).normalize(),
    )
    return new_carry, world, det


def _prep_frame(frame: np.ndarray, packed: bool, cfg) -> np.ndarray:
    """Normalize one source frame for upload: raw f32 grid, or the packed
    wire format (pass-through for already-packed u8, host-encode for
    grids). Shared by the offline driver and the push API."""
    frame = np.asarray(frame)
    if not packed:
        return frame.astype(np.float32, copy=False)
    if frame.dtype == np.uint8:
        return frame
    from ..io.packed import encode_packed_grid

    return encode_packed_grid(frame, cfg[0], cfg[1], cfg[2])


class StreamingOdometry:
    """Incremental push API over the pipelined chunk backend.

    The reference's usage model is a pull loop the user writes
    (``README.md:44-60``); :func:`odometry_streaming` covers the offline
    file-fed form of it. This class covers the LIVE form — a sensor
    callback pushing scans one at a time — while keeping the same
    asynchronous chunked execution underneath:

        odo = StreamingOdometry(lidar, chunk_frames=8)
        for scan in sensor:              # (L, P, 3) grids or packed planes
            for frame_idx, pose in odo.push(scan):
                ...                      # world poses as chunks complete
        for frame_idx, pose in odo.finish():
            ...

    ``push`` buffers until a chunk fills, then dispatches upload + compute
    asynchronously and returns the COMPLETED poses it can hand out without
    blocking the device (the just-dispatched chunk's results are returned
    by a later push/finish — one chunk of latency buys full overlap).
    ``finish`` pads and flushes the tail. Poses are ``Pose3`` scalars with
    their global frame index.
    """

    def __init__(
        self,
        lidar: LidarParams,
        feat_params: FeatureExtractionParams = FeatureExtractionParams(),
        reg_params: RegistrationParams = RegistrationParams(),
        chunk_frames: int = 8,
        packed: bool = True,
        motion_init: bool = True,
        elev_lo: float = -0.30,
        elev_hi: float = 0.25,
        dewarp: bool = False,
    ):
        from ..io.packed import PACKED_R_MAX

        self._lidar = lidar
        self._feat = feat_params
        self._reg = reg_params
        self._K = int(chunk_frames)
        self._packed = packed
        self._motion = motion_init
        self._cfg = (elev_lo, elev_hi, PACKED_R_MAX) if packed else None
        self._dewarp = dewarp
        self._carry = stream_init(lidar, feat_params)
        self._buf: list = []
        self._pending: list = []  # [(start_frame, n_real, world, det)]
        self._n = 0
        self._done = False

    def _dispatch(self, n_real: int):
        dev = jax.device_put(np.stack(self._buf))
        self._carry, world, det = stream_chunk_step(
            self._carry, dev, self._lidar, self._feat, self._reg,
            self._cfg, self._motion, self._dewarp,
        )
        self._pending.append((self._n - n_real, n_real, world, det))
        self._buf.clear()

    def _drain(self, block: bool) -> list:
        out = []
        # hand out every chunk except the newest (still in flight) unless
        # blocking; reading results forces completion
        keep = 0 if block else 1
        while len(self._pending) > keep:
            start, n_real, world, det = self._pending.pop(0)
            # np.asarray is the completion barrier; hand the poses out as
            # host arrays (re-wrapping in jnp would re-upload each one)
            t = np.asarray(world.translation)[:n_real]
            q = np.asarray(world.rotation)[:n_real]
            out.extend(
                (start + j, Pose3(q[j], t[j])) for j in range(n_real)
            )
        return out

    def push(self, scan: np.ndarray) -> list:
        """Feed one scan; returns [(frame_index, world_T_frame), ...] for
        any frames whose chunks have completed (possibly empty)."""
        if self._done:
            raise RuntimeError("push() after finish()")
        self._buf.append(_prep_frame(scan, self._packed, self._cfg))
        self._n += 1
        if len(self._buf) == self._K:
            self._dispatch(self._K)
        return self._drain(block=False)

    def finish(self) -> list:
        """Flush the buffered tail (padding the last chunk) and return the
        remaining poses. The instance cannot be pushed to afterwards."""
        self._done = True
        if self._buf:
            n_real = len(self._buf)
            self._buf.extend([self._buf[-1]] * (self._K - n_real))
            self._dispatch(n_real)
        return self._drain(block=True)

    @property
    def frames_pushed(self) -> int:
        return self._n


def odometry_streaming(
    source: Union[Sequence[str], np.ndarray, Iterable[np.ndarray]],
    lidar: LidarParams,
    feat_params: FeatureExtractionParams = FeatureExtractionParams(),
    reg_params: RegistrationParams = RegistrationParams(),
    chunk_frames: int = 16,
    packed: bool = True,
    motion_init: bool = True,
    n_threads: int = 4,
    queue_cap: int = 32,
    elev_lo: float = -0.30,
    elev_hi: float = 0.25,
    dewarp: bool = False,
) -> Tuple[Pose3, RegistrationDetail]:
    """File-fed odometry with IO, upload and compute pipelined.

    Args:
      source: a list of ``.bin``/``.pcd`` paths (native prefetch loader), a
        stacked (F, L, P, 3) array, or any iterable of per-frame grids /
        packed planes.
      chunk_frames: frames per upload+compute quantum. Larger chunks
        amortize the per-transfer/dispatch overhead; smaller chunks overlap
        more finely.
      packed: ship scans in the 4-byte/point wire format (3x fewer upload
        bytes; quantization below sensor noise — see ``io/packed.py``). For
        path sources the native loader packs in its worker threads; array
        sources are packed on the host thread.
      elev_lo / elev_hi: the sensor's vertical FOV (rad) — used both by the
        file projection and by the packed codec's per-row elevation cells.
        MUST match the geometry of the data: the codec quantizes elevation
        offsets against these rows, so a wrong FOV snaps points into wrong
        cells (meters of error at range) instead of raising. Defaults match
        ``project_range_image`` / the synthetic renderer.

    Returns:
      (trajectory, details): trajectory is (F,) world poses with frame 0 at
      identity; details has (F-1,) leaves for pairs (i-1, i), matching
      ``odometry_offline``.
    """
    from ..io.native import ScanLoader
    from ..io.packed import PACKED_R_MAX

    packed_cfg = (elev_lo, elev_hi, PACKED_R_MAX) if packed else None
    K = int(chunk_frames)
    loader = None
    if (
        isinstance(source, (list, tuple))
        and source
        and isinstance(source[0], str)
    ):
        loader = ScanLoader(
            list(source), lidar.scan_lines, lidar.points_per_line,
            elev_lo, elev_hi, n_threads=n_threads, queue_cap=queue_cap,
            packed=packed,
        )
        frames_iter = iter(loader)
    elif isinstance(source, np.ndarray) or hasattr(source, "shape"):
        frames_iter = iter(np.asarray(source))
    else:
        frames_iter = iter(source)

    carry = stream_init(lidar, feat_params)
    worlds, dets = [], []
    buf: list = []
    n_frames = 0
    n_pad = 0

    def flush():
        nonlocal carry
        dev = jax.device_put(np.stack(buf))  # async upload
        carry, world, det = stream_chunk_step(
            carry, dev, lidar, feat_params, reg_params, packed_cfg,
            motion_init, dewarp,
        )  # async dispatch; no barrier
        worlds.append(world)
        dets.append(det)
        buf.clear()

    try:
        for frame in frames_iter:
            buf.append(_prep_frame(frame, packed, packed_cfg))
            n_frames += 1
            if len(buf) == K:
                flush()
        if buf:
            n_pad = K - len(buf)
            buf.extend([buf[-1]] * n_pad)  # pad; sliced off below
            flush()
    finally:
        if loader is not None:
            loader.close()

    if n_frames == 0:
        raise ValueError("odometry_streaming: empty source")
    cat = lambda xs: jax.tree.map(
        lambda *ls: jnp.concatenate(ls, axis=0)[:n_frames], *xs
    )
    trajectory = cat(worlds)
    details = jax.tree.map(lambda x: x[1:], cat(dets))  # drop the dummy
    return trajectory, details

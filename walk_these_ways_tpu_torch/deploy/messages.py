"""Deployment wire messages.

Rebuild of the reference's LCM IDL types (reference: go1_gym_deploy/
lcm_types/*.lcm — leg_control_data_lcmt, pd_tau_targets_lcmt,
rc_command_lcmt, state_estimator_lcmt) as fixed-layout little-endian
structs.  The reference generates Python/C++ bindings from LCM IDL; we use
explicit struct packing shared by the Python agent (this module) and the
C++ bridge (deploy/cpp/wire.h) — same fields, same channels, no codegen.

All floats are f32, ints i32/i8; layouts are packed (no padding).
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import ClassVar, List

CHANNEL_LEG_CONTROL = "leg_control_data"
CHANNEL_STATE_ESTIMATOR = "state_estimator_data"
CHANNEL_RC_COMMAND = "rc_command"
CHANNEL_PD_TARGETS = "pd_plustau_targets"
CHANNEL_CAMERA = "camera_frame"

# Onboard camera ids (reference cheetah_state_estimator.py:318-334:
# channels camera1..camera5 / rect_image_{name}).
CAMERA_NAMES = ("front", "bottom", "left", "right", "rear")


def _pack_floats(vals):
    return struct.pack(f"<{len(vals)}f", *vals)


@dataclass
class LegControlData:
    """q/qd/tau per joint (reference leg_control_data_lcmt)."""
    FMT: ClassVar[str] = "<36f"
    q: List[float] = field(default_factory=lambda: [0.0] * 12)
    qd: List[float] = field(default_factory=lambda: [0.0] * 12)
    tau_est: List[float] = field(default_factory=lambda: [0.0] * 12)

    def encode(self) -> bytes:
        return struct.pack(self.FMT, *self.q, *self.qd, *self.tau_est)

    @classmethod
    def decode(cls, data: bytes) -> "LegControlData":
        v = struct.unpack(cls.FMT, data[: struct.calcsize(cls.FMT)])
        return cls(q=list(v[0:12]), qd=list(v[12:24]), tau_est=list(v[24:36]))


@dataclass
class PdTauTargets:
    """PD targets + feedforward torque (reference pd_tau_targets_lcmt)."""
    FMT: ClassVar[str] = "<60f i"
    q_des: List[float] = field(default_factory=lambda: [0.0] * 12)
    qd_des: List[float] = field(default_factory=lambda: [0.0] * 12)
    kp: List[float] = field(default_factory=lambda: [0.0] * 12)
    kd: List[float] = field(default_factory=lambda: [0.0] * 12)
    tau_ff: List[float] = field(default_factory=lambda: [0.0] * 12)
    id: int = 0

    def encode(self) -> bytes:
        return struct.pack(self.FMT, *self.q_des, *self.qd_des, *self.kp,
                           *self.kd, *self.tau_ff, self.id)

    @classmethod
    def decode(cls, data: bytes) -> "PdTauTargets":
        v = struct.unpack(cls.FMT, data[: struct.calcsize(cls.FMT)])
        return cls(q_des=list(v[0:12]), qd_des=list(v[12:24]),
                   kp=list(v[24:36]), kd=list(v[36:48]),
                   tau_ff=list(v[48:60]), id=v[60])


@dataclass
class RcCommand:
    """Joystick state (reference rc_command_lcmt)."""
    FMT: ClassVar[str] = "<5f 5i"
    left_stick_x: float = 0.0
    left_stick_y: float = 0.0
    right_stick_x: float = 0.0
    right_stick_y: float = 0.0
    knob: float = 0.0
    mode: int = 0
    left_upper_switch: int = 0
    left_lower_left_switch: int = 0
    right_upper_switch: int = 0
    right_lower_right_switch: int = 0

    def encode(self) -> bytes:
        return struct.pack(
            self.FMT, self.left_stick_x, self.left_stick_y,
            self.right_stick_x, self.right_stick_y, self.knob, self.mode,
            self.left_upper_switch, self.left_lower_left_switch,
            self.right_upper_switch, self.right_lower_right_switch)

    @classmethod
    def decode(cls, data: bytes) -> "RcCommand":
        v = struct.unpack(cls.FMT, data[: struct.calcsize(cls.FMT)])
        return cls(*v)


class CameraFrame:
    """Fragmented camera image (reference camera_message_lcmt /
    camera_message_rect_wide, go1_gym_deploy/lcm_types/*).

    The reference relies on LCM's built-in datagram fragmentation for its
    278400-byte raw frames; our bus sends raw UDP datagrams, so the frame
    carries its own fragment header:
    ``cam_id(u8) channels(u8) width(u16) height(u16) frame_seq(u16)
    n_frags(u16) frag_idx(u16) frag_off(u32)`` followed by the fragment
    bytes.  Image payload is HWC uint8.
    """

    HEADER_FMT: ClassVar[str] = "<BBHHHHHxxI"
    HEADER_SIZE: ClassVar[int] = struct.calcsize("<BBHHHHHxxI")
    MAX_FRAG: ClassVar[int] = 32768

    @classmethod
    def encode_fragments(cls, cam_id: int, frame_seq: int,
                         image) -> List[bytes]:
        import numpy as np

        img = np.ascontiguousarray(image, dtype=np.uint8)
        assert img.ndim == 3, "camera frame must be HWC"
        h, w, c = img.shape
        raw = img.tobytes()
        n_frags = max(1, (len(raw) + cls.MAX_FRAG - 1) // cls.MAX_FRAG)
        out = []
        for i in range(n_frags):
            off = i * cls.MAX_FRAG
            frag = raw[off: off + cls.MAX_FRAG]
            hdr = struct.pack(cls.HEADER_FMT, cam_id, c, w, h,
                              frame_seq & 0xFFFF, n_frags, i, off)
            out.append(hdr + frag)
        return out

    @classmethod
    def decode_header(cls, payload: bytes):
        cam_id, c, w, h, seq, n_frags, idx, off = struct.unpack(
            cls.HEADER_FMT, payload[: cls.HEADER_SIZE])
        return dict(cam_id=cam_id, channels=c, width=w, height=h,
                    frame_seq=seq, n_frags=n_frags, frag_idx=idx,
                    frag_off=off, data=payload[cls.HEADER_SIZE:])


class FrameAssembler:
    """Reassembles CameraFrame fragments into HWC uint8 arrays; drops
    incomplete frames when a newer sequence number arrives."""

    def __init__(self):
        self._partial = {}          # cam_id -> (seq, buf, missing)

    def push(self, payload: bytes):
        """Returns (cam_id, image) when a frame completes, else None."""
        import numpy as np

        m = CameraFrame.decode_header(payload)
        cam, seq = m["cam_id"], m["frame_seq"]
        total = m["height"] * m["width"] * m["channels"]
        cur = self._partial.get(cam)
        if cur is None or cur[0] != seq:
            cur = (seq, bytearray(total), set(range(m["n_frags"])))
            self._partial[cam] = cur
        _, buf, missing = cur
        buf[m["frag_off"]: m["frag_off"] + len(m["data"])] = m["data"]
        missing.discard(m["frag_idx"])
        if missing:
            return None
        del self._partial[cam]
        img = np.frombuffer(bytes(buf), dtype=np.uint8).reshape(
            m["height"], m["width"], m["channels"])
        return cam, img


@dataclass
class StateEstimate:
    """IMU + estimator output (reference state_estimator_lcmt)."""
    FMT: ClassVar[str] = "<3f 3f 3f 3f 4f 3f 4f"
    p: List[float] = field(default_factory=lambda: [0.0] * 3)
    vWorld: List[float] = field(default_factory=lambda: [0.0] * 3)
    rpy: List[float] = field(default_factory=lambda: [0.0] * 3)
    omegaBody: List[float] = field(default_factory=lambda: [0.0] * 3)
    quat: List[float] = field(default_factory=lambda: [1.0, 0.0, 0.0, 0.0])
    aBody: List[float] = field(default_factory=lambda: [0.0] * 3)
    contact_estimate: List[float] = field(default_factory=lambda: [0.0] * 4)

    def encode(self) -> bytes:
        return struct.pack(self.FMT, *self.p, *self.vWorld, *self.rpy,
                           *self.omegaBody, *self.quat, *self.aBody,
                           *self.contact_estimate)

    @classmethod
    def decode(cls, data: bytes) -> "StateEstimate":
        v = struct.unpack(cls.FMT, data[: struct.calcsize(cls.FMT)])
        return cls(p=list(v[0:3]), vWorld=list(v[3:6]), rpy=list(v[6:9]),
                   omegaBody=list(v[9:12]), quat=list(v[12:16]),
                   aBody=list(v[16:19]), contact_estimate=list(v[19:23]))

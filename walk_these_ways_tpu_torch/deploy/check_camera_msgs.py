#!/usr/bin/env python3
"""Camera-stream check: subscribe to the bus camera channel and print
per-camera frame rates.

Analog of the reference's `go1_gym_deploy/tests/check_camera_msgs.py`
(154 LoC): run it on the deploy host while the robot's camera publishers
are up to confirm frames arrive and reassemble at the expected rate.

    python -m walk_these_ways_tpu_torch.deploy.check_camera_msgs [--seconds 10]

With --self-test it publishes synthetic frames from a background thread
over the loopback bus and checks its own counters — usable without the
robot (and exercised by tests/test_deploy_extras.py).
"""
from __future__ import annotations

import argparse
import threading
import time
from collections import defaultdict

from . import messages as msg
from .bus import DEFAULT_PORT, Bus
from .messages import CameraFrame, FrameAssembler


class CameraRateMonitor:
    def __init__(self, bus: Bus):
        self.assembler = FrameAssembler()
        self.counts = defaultdict(int)
        self.shapes = {}
        self.t0 = time.time()
        bus.subscribe(msg.CHANNEL_CAMERA, self._on_fragment)

    def _on_fragment(self, payload: bytes):
        done = self.assembler.push(payload)
        if done is not None:
            cam_id, img = done
            self.counts[cam_id] += 1
            self.shapes[cam_id] = img.shape

    def report(self) -> dict:
        dt = max(time.time() - self.t0, 1e-9)
        out = {}
        for cam_id in sorted(self.counts):
            name = (msg.CAMERA_NAMES[cam_id]
                    if cam_id < len(msg.CAMERA_NAMES) else str(cam_id))
            out[name] = (self.counts[cam_id] / dt, self.shapes[cam_id])
        return out


def main(seconds: float = 10.0, self_test: bool = False,
         port: int = DEFAULT_PORT) -> dict:
    bus = Bus(port=port)
    mon = CameraRateMonitor(bus)
    stop = threading.Event()
    if self_test:
        import numpy as np

        def feed():
            seq = 0
            img = np.zeros((30, 40, 3), np.uint8)
            while not stop.is_set():
                for frag in CameraFrame.encode_fragments(0, seq, img):
                    bus.publish(msg.CHANNEL_CAMERA, frag)
                seq += 1
                time.sleep(0.02)

        t = threading.Thread(target=feed, daemon=True)
        t.start()
    end = time.time() + seconds
    while time.time() < end:
        bus.handle_once(timeout=0.1)
    stop.set()
    rep = mon.report()
    if not rep:
        print("no camera frames received — is the publisher running and "
              "the multicast route configured (deploy/network_config.py)?")
    for name, (fps, shape) in rep.items():
        print(f"{name}: {fps:.1f} frames/s, shape {shape}")
    return rep


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--self-test", action="store_true")
    p.add_argument("--port", type=int, default=DEFAULT_PORT)
    a = p.parse_args()
    main(a.seconds, a.self_test, a.port)

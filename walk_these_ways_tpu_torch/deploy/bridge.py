"""Build the C++ UDP bridge (cpp/udp_bridge.cpp) at first use.

    path = bridge.build()              # the robot's bus port, 7667
    path = bridge.build(port=7811)     # a bridge on a port of its own

`g++ -O2 -std=c++17 -pthread` compiles the source into
`build/udp_bridge_<port>_<hash>/udp_bridge` at the repo root (or
`$WTW_TORCH_BUILD_DIR`), keyed by the source, `wire.h` and the port; a
build that exists is reused.  The port is a compile-time define of
`wire.h` (`WTW_BUS_PORT`), so a test or a smoke run can drive a loopback
on a port no other bridge on the host uses.  Run the binary with `--sim`
for the loopback joint simulator, `--ticks N` to stop after N ticks at
500 Hz.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile

from ..ops._build import build_dir
from .bus import DEFAULT_PORT

CPP = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cpp")
SOURCES = ("udp_bridge.cpp", "wire.h")
FLAGS = ("-O2", "-std=c++17", "-pthread")


def build(port: int = DEFAULT_PORT) -> str:
    """Path of the bridge binary for `port`, compiled if not yet built."""
    h = hashlib.sha256(repr((FLAGS, port)).encode())
    for name in SOURCES:
        with open(os.path.join(CPP, name), "rb") as f:
            h.update(f.read())
    out_dir = os.path.join(build_dir(),
                           f"udp_bridge_{port}_{h.hexdigest()[:12]}")
    exe = os.path.join(out_dir, "udp_bridge")
    if os.path.exists(exe):
        return exe
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("building the UDP bridge needs g++, not found")
    os.makedirs(out_dir, exist_ok=True)
    # compile beside the target and rename: a concurrent build never sees
    # a half-written binary
    fd, tmp = tempfile.mkstemp(dir=out_dir, prefix=".udp_bridge.")
    os.close(fd)
    try:
        r = subprocess.run(
            [cxx, *FLAGS, f"-DWTW_BUS_PORT={int(port)}", "-o", tmp,
             os.path.join(CPP, "udp_bridge.cpp")],
            capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"building the UDP bridge failed:\n{r.stderr}")
        os.chmod(tmp, 0o755)
        os.replace(tmp, exe)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return exe

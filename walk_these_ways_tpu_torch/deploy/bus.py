"""UDP-multicast pub/sub bus (LCM replacement).

The reference's only distributed communication is LCM over UDP multicast
(reference: go1_gym_deploy/scripts/deploy_policy.py:13 —
``udpm://239.255.76.67:7667?ttl=255``).  This is a dependency-free
equivalent with the same topology: datagrams carry
``magic(4s) | channel_len(u8) | channel | payload``; the C++ bridge
(deploy/cpp) speaks the same framing.  A loopback multicast group keeps it
testable on any host.
"""
from __future__ import annotations

import select
import socket
import struct
import threading
from typing import Callable, Dict, List

MAGIC = b"WTW1"
DEFAULT_GROUP = "239.255.76.67"
DEFAULT_PORT = 7667


class Bus:
    def __init__(self, group: str = DEFAULT_GROUP, port: int = DEFAULT_PORT,
                 ttl: int = 0, loopback: bool = True):
        self.group = group
        self.port = port
        self._handlers: Dict[str, List[Callable[[bytes], None]]] = {}
        self._tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._tx.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_TTL, ttl)
        self._tx.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_LOOP,
                            1 if loopback else 0)
        self._rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._rx.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._rx.bind(("", port))
        mreq = struct.pack("4sl", socket.inet_aton(group), socket.INADDR_ANY)
        self._rx.setsockopt(socket.IPPROTO_IP, socket.IP_ADD_MEMBERSHIP, mreq)
        self._thread = None
        self._running = False

    def publish(self, channel: str, payload: bytes) -> None:
        ch = channel.encode()
        pkt = MAGIC + bytes([len(ch)]) + ch + payload
        self._tx.sendto(pkt, (self.group, self.port))

    def subscribe(self, channel: str, handler: Callable[[bytes], None]) -> None:
        self._handlers.setdefault(channel, []).append(handler)

    def handle_once(self, timeout: float = 0.0) -> bool:
        """Poll for one datagram; dispatch to handlers. Returns True if a
        message was handled (reference cheetah_state_estimator.py:375-395
        poll loop)."""
        r, _, _ = select.select([self._rx], [], [], timeout)
        if not r:
            return False
        data, _ = self._rx.recvfrom(65536)
        if len(data) < 5 or data[:4] != MAGIC:
            return False
        n = data[4]
        channel = data[5:5 + n].decode()
        payload = data[5 + n:]
        for h in self._handlers.get(channel, []):
            h(payload)
        return True

    def spin(self) -> None:
        """Background dispatch thread (reference's se.spin())."""
        self._running = True

        def loop():
            while self._running:
                self.handle_once(timeout=0.05)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=1.0)

    def close(self) -> None:
        self.stop()
        self._tx.close()
        self._rx.close()

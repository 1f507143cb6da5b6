#!/usr/bin/env python3
"""Configure the deploy host's network interface for the UDP-multicast bus.

Analog of the reference's `go1_gym_deploy/utils/network_config_unitree.py`:
find the interface on the robot's wired subnet (192.168.123.x on the Go1's
internal LAN), enable multicast on it, and route the 224.0.0.0/4 multicast
block through it so the bus datagrams (deploy/bus.py, default group
239.255.76.67:7667 — the reference's LCM group) leave on the right link.

Dependency-free: interface discovery parses `ip -o addr` instead of
netifaces (not installed on the robot image); the chosen name is cached in
~/.wtw_network.txt like the reference's ~/.cheetah_network.txt.
"""
from __future__ import annotations

import os
import re
import subprocess
import sys

CACHE = os.path.expanduser("~/.wtw_network.txt")
ROBOT_SUBNET = "192.168.123."


def get_saved_interface_name() -> str:
    try:
        with open(CACHE) as f:
            return f.read().split()[0]
    except (OSError, IndexError):
        return ""


def list_interfaces() -> dict[str, list[str]]:
    """interface -> [ipv4 addrs], parsed from `ip -o -4 addr show`."""
    out = subprocess.run(["ip", "-o", "-4", "addr", "show"],
                         capture_output=True, text=True).stdout
    if_to_addrs: dict[str, list[str]] = {}
    for line in out.splitlines():
        m = re.match(r"\d+:\s+(\S+)\s+inet\s+([\d.]+)/", line)
        if m:
            if_to_addrs.setdefault(m.group(1), []).append(m.group(2))
    return if_to_addrs


def get_likely_iface() -> str:
    if_to_addrs = list_interfaces()
    print(f"Found {len(if_to_addrs)} interfaces:")
    for i, (name, addrs) in enumerate(if_to_addrs.items()):
        print(f"  [{i}] : {name} : {addrs}")
    matches = [name for name, addrs in if_to_addrs.items()
               if any(a.startswith(ROBOT_SUBNET) for a in addrs)]
    if not matches:
        print("None of the network adapters look correct. Make sure you "
              f"have a static {ROBOT_SUBNET}x address on the robot link!")
        return ""
    if len(matches) > 1:
        print(f"Found {len(matches)} possible adapters, giving up")
        return ""
    print(f"The adapter {matches[0]} seems correct")
    return matches[0]


def main() -> None:
    name = get_saved_interface_name()
    if name:
        print(f"Found saved interface {name}")
    else:
        print("Didn't find saved interface, searching...")
        name = get_likely_iface()
        if not name:
            sys.exit("Failed to find network adapter name")
        try:
            with open(CACHE, "w") as f:
                f.write(name + "\n")
        except OSError:
            pass
    print(f"Setup for interface {name}")
    subprocess.call(["sudo", "ip", "link", "set", name, "multicast", "on"])
    subprocess.call(["sudo", "ip", "route", "replace", "224.0.0.0/4",
                     "dev", name])


if __name__ == "__main__":
    main()

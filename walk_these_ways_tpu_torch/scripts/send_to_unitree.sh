#!/bin/bash
# Sync the port's deploy stack + trained runs to the Go1's onboard computer
# (counterpart of reference go1_gym_deploy/scripts/send_to_unitree.sh).
#
# Usage: walk_these_ways_tpu_torch/scripts/send_to_unitree.sh [user@host] [runs-dir]
#        (defaults unitree@192.168.123.15 and runs)
#
# The robot's side is numpy only (walk_these_ways_tpu_torch/deploy): it
# needs no GPU.  On the robot, build and start the bridge, then the policy:
#   python3 -c 'from walk_these_ways_tpu_torch.deploy import bridge; print(bridge.build())'
#   build/udp_bridge_7667_*/udp_bridge &
#   python3 -m walk_these_ways_tpu_torch.deploy.deploy_policy \
#       --policy runs/<run>/checkpoints/policy_latest.npz
set -e
DEST="${1:-unitree@192.168.123.15}"
ROOT="$(cd "$(dirname "$0")/../.." && pwd)"
RUNS="${2:-$ROOT/runs}"

rsync -av -e ssh \
    --exclude='*.mp4' --exclude='__pycache__' --exclude='csrc' \
    "$ROOT/walk_these_ways_tpu_torch" \
    "$ROOT/resources" \
    "$RUNS" \
    "$DEST:/home/unitree/go1_gym"

echo "Synced to $DEST:/home/unitree/go1_gym"

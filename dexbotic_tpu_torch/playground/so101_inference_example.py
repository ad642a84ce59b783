"""Example: drive a SO-101 arm from a deployed action server (port of
playground/so101_inference_example.py).

Start a policy server first (any exp's ``--task inference``), then run the
gRPC bridge that adapts LeRobot's async-inference protocol:

    python -m dexbotic_tpu_torch.playground.benchmarks.libero.libero_cogact --task inference
    python -m dexbotic_tpu_torch.playground.so101.bridge_server \
        --server_url http://localhost:7891/process_frame

This script shows the plain DexClient loop that the bridge wraps.
"""

import numpy as np

from dexbotic_tpu_torch.client import DexClient


def main():
    client = DexClient(
        url="http://localhost:7891/process_frame",
        execute_steps=8,  # ask the server again after this many actions
    )
    instruction = "pick up the red block"
    for step in range(100):
        frame = np.zeros((480, 640, 3), np.uint8)  # replace with a camera read
        action = client.act(frame, instruction)
        print(f"step {step}: action {np.round(np.asarray(action), 3).tolist()}")
        # send `action` to the robot controller here


if __name__ == "__main__":
    main()

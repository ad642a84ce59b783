"""SO-101 gRPC bridge: LeRobot's async-inference protocol -> a /process_frame
action server (port of hardware/so101/bridge_server.py).

A gRPC AsyncInference servicer takes the observation stream of a LeRobot
robot client, forwards each frame and state to the HTTP action server
through DexClient, and streams the actions back as TimedAction messages.
It needs LeRobot's generated ``async_inference_pb2*`` modules and ``grpc``
(an import gated as in the JAX file: without them the servicer is not
defined and ``main`` exits); ``BridgeState`` needs neither.

    python -m dexbotic_tpu_torch.playground.so101.bridge_server \
        --server_url http://localhost:7891/process_frame --instruction "pick up the block"
"""

from __future__ import annotations

import argparse
import pickle
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from dexbotic_tpu_torch.client import DexClient

try:
    import grpc
    from lerobot.transport import (  # type: ignore
        async_inference_pb2,
        async_inference_pb2_grpc,
    )

    _HAVE_GRPC = True
except ImportError:
    _HAVE_GRPC = False


class BridgeState:
    """The bridge's queues: observations in (two at most, the stale ones
    dropped), (timestep, action) pairs out."""

    def __init__(self, client: DexClient, instruction: str, camera_key: str, state_key: str):
        self.client = client
        self.instruction = instruction
        self.camera_key = camera_key
        self.state_key = state_key
        self.obs_queue: queue.Queue = queue.Queue(maxsize=2)
        self.action_queue: queue.Queue = queue.Queue()
        self.running = True

    def worker(self):
        """obs queue -> DexClient -> timed actions, until ``running`` is cleared."""
        while self.running:
            try:
                timestep, obs = self.obs_queue.get(timeout=1.0)
            except queue.Empty:
                continue
            action = self.client.act(obs.get(self.camera_key), self.instruction,
                                     state=obs.get(self.state_key))
            self.action_queue.put((timestep, np.asarray(action)))


if _HAVE_GRPC:

    class AsyncInferenceServicer(async_inference_pb2_grpc.AsyncInferenceServicer):
        def __init__(self, state: BridgeState):
            self.state = state

        def Ready(self, request, context):
            return async_inference_pb2.Empty()

        def SendObservations(self, request_iterator, context):
            for obs_msg in request_iterator:
                obs = pickle.loads(obs_msg.data)
                ts = obs.get("timestep", time.monotonic())
                try:
                    self.state.obs_queue.put_nowait((ts, obs))
                except queue.Full:
                    pass  # drop stale frames
            return async_inference_pb2.Empty()

        def StreamActions(self, request, context):
            while self.state.running:
                try:
                    ts, action = self.state.action_queue.get(timeout=1.0)
                except queue.Empty:
                    continue
                yield async_inference_pb2.TimedAction(timestep=int(ts),
                                                      data=pickle.dumps(action))

        def SendPolicyInstructions(self, request, context):
            spec = pickle.loads(request.data)
            self.state.instruction = spec.get("task", self.state.instruction)
            return async_inference_pb2.Empty()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--server_url", default="http://localhost:7891/process_frame")
    ap.add_argument("--port", type=int, default=8765)
    ap.add_argument("--instruction", default="")
    ap.add_argument("--camera_key", default="observation.images.front")
    ap.add_argument("--state_key", default="observation.state")
    ap.add_argument("--execute_steps", type=int, default=8)
    args = ap.parse_args()

    if not _HAVE_GRPC:
        raise SystemExit("grpc + lerobot transport stubs required for the SO-101 bridge")

    state = BridgeState(DexClient(url=args.server_url, execute_steps=args.execute_steps),
                        args.instruction, args.camera_key, args.state_key)
    threading.Thread(target=state.worker, daemon=True).start()

    server = grpc.server(ThreadPoolExecutor(8))
    async_inference_pb2_grpc.add_AsyncInferenceServicer_to_server(
        AsyncInferenceServicer(state), server)
    server.add_insecure_port(f"[::]:{args.port}")
    server.start()
    print(f"SO-101 bridge listening on :{args.port} -> {args.server_url}")
    server.wait_for_termination()


if __name__ == "__main__":
    main()

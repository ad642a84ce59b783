"""The SO-101 arm's gRPC bridge to a /process_frame server."""

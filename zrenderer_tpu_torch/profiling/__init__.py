"""Profiling of the port: ``ztracy``'s zones and frame marks over
torch.profiler and NVTX.  Import the submodule directly."""

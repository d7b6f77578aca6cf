"""Engine layer of the port: scene upload, config, pools, stats, the
staging ring and the Renderer.  Import the submodules directly."""

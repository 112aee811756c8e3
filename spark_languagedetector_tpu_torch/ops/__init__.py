"""Device operations of the port: encoders, scorers, the fit, and the
hand-written CUDA kernels' wrappers. The kernels' two failure types are
exported here; the retry policy refuses both."""

from ._kernels import KernelBuildError, KernelLaunchError

__all__ = ["KernelBuildError", "KernelLaunchError"]

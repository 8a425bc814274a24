"""Public entry points of the port's kernels.

Counterpart of ``repro/kernels/ops.py`` for the four kernels of the main
path, with the same keyword arguments minus the routing knobs
(``backend``, ``policy``) and the Pallas tile of ``mandelbrot``: routing
and the tuned tier come with ROADMAP queue 1 slice 11. Here the device
decides. A CPU tensor (or ``device="cpu"``) takes the plain version; a
CUDA tensor launches the hand-written kernel or raises. Nothing falls
back. Each entry point is the kernel module's wrapper itself, so its
``launches`` counter is shared.

``region_fill`` and ``region_dwell`` update the canvas in place and return
it (the JAX versions are functional, through ``input_output_aliases``).
Their third argument, and ``perimeter_query``'s second, is ``count``, the
live row count as an int32 [1] tensor on the device, where JAX takes a
duplicate-padded OLT (and, for the fill and the dwell, a ``nonempty``
flag); no kernel does work for a row past it.
"""

from repro_torch.kernels.mandelbrot_dwell import mandelbrot_dwell as mandelbrot
from repro_torch.kernels.perimeter_query import perimeter_query
from repro_torch.kernels.region_dwell import region_dwell
from repro_torch.kernels.region_fill import region_fill

__all__ = ["mandelbrot", "perimeter_query", "region_fill", "region_dwell"]

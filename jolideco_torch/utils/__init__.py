"""Host-side helpers: analytic kernels, norms, kernel builds, interop."""

"""Device->host transfer helpers.

Complex results are fetched as (re, im) real planes and recombined on the
host (the code base's real-plane convention; see ROADMAP queue 3)."""
import numpy as np
import jax
import jax.numpy as jnp


@jax.jit
def _split(x):
    # one jitted split instead of two eager dispatches
    return jnp.real(x), jnp.imag(x)


def fetch(x):
    """numpy copy of a jax array; complex arrays go through real planes.
    Host (numpy) inputs pass through without touching the device."""
    if not isinstance(x, jax.Array):
        return np.asarray(x)
    if jnp.issubdtype(x.dtype, jnp.complexfloating):
        re, im = _split(x)
        return np.asarray(re) + 1j * np.asarray(im)
    return np.asarray(x)


def fetch_scalar(x):
    v = fetch(x)
    return complex(v) if np.iscomplexobj(v) else float(v)

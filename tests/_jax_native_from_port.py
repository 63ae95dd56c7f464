"""The port's parity tests hand the JAX package's native loader the port's
build of the same C++ library, so they never run ``make -C native``.

``multiverso_tpu.native.lib()`` builds a missing library with ``make -C
native`` in the checkout's ``native/`` directory and keeps a failed load
for the life of its process. pytest workers that run that make at once
write the same object files, and a worker that loads the library while
another relinks it keeps no library for the rest of its run. The port
compiles the same sources with the same flags (read from
``native/Makefile``) into ``build/native_torch/<hash>/``, under a file
lock, moved into place once complete (``multiverso_tpu_torch/native.py``).
For the duration of each port test, the JAX loader returns that build (or
None without a compiler: the JAX package then takes its Python paths),
and a make from the JAX loader fails the test.

Use: ``from _jax_native_from_port import jax_native_from_port  # noqa``
in a test module; the fixture is autouse.
"""

import functools

import pytest


@functools.lru_cache(maxsize=None)
def _port_library():
    """The port's build loaded through the JAX package's own loader
    (its signature check included), or None."""
    from multiverso_tpu import native as jnative
    from multiverso_tpu_torch import native as tnative
    path = tnative.build()
    return None if path is None else jnative._try_load(str(path))


@pytest.fixture(autouse=True)
def jax_native_from_port(monkeypatch):
    from multiverso_tpu import native as jnative

    def no_make():
        raise AssertionError("a port test ran the JAX loader's make -C native")

    monkeypatch.setattr(jnative, "_lib", _port_library())
    monkeypatch.setattr(jnative, "_tried", True)
    monkeypatch.setattr(jnative, "_build", no_make)


#: ``python -c JAX_READER_SRC LIBPATH ARGS...`` runs the JAX package's
#: replica reader (``multiverso_tpu.replica.replica.main(ARGS)``) with the
#: port's build of the library handed to its loader (LIBPATH, "" = none),
#: as the fixture above does in-process: no ``make``, and the same CRC
#: engine as a port process on the other end of its ring
JAX_READER_SRC = r'''
import sys
from multiverso_tpu import native as jnative


def no_make():
    raise AssertionError("the JAX loader ran make -C native")


jnative._lib = jnative._try_load(sys.argv[1]) if sys.argv[1] else None
jnative._tried = True
jnative._build = no_make
from multiverso_tpu.replica.replica import main
sys.exit(main(sys.argv[2:]))
'''

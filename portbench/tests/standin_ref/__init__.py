"""A stand-in plain reference for the tests: the modules of
portbench/reference/wtw loaded again under this package's name (its path is
that directory's), so that a configuration that names this package can be
seen to build its reference side from it."""
import os

__path__ = [os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "reference", "wtw")]

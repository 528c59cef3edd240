"""Intentional user-facing error paths.

The reference reports user errors through ``error()`` (printf + ``abort()``,
debug.cpp:44-52), which the CLI mirrors as
``error: <msg>`` on stderr and exit status 134 (SIGABRT).  Only errors raised
as :class:`ParityError` (or :class:`~.io.fasta.FastaError`) take that path;
unexpected internal exceptions map to the reference's generic
``ERROR:<what>`` + exit 2 handler (main.cpp:315-319) instead of being
silently absorbed.
"""


class ParityError(ValueError):
    """A deliberate reference-``error()``-equivalent diagnostic."""

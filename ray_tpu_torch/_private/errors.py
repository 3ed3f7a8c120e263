"""Exceptions the port's engine raises (copied from ray_tpu's taxonomy)."""

from __future__ import annotations


class RayError(Exception):
    """Base for all framework errors."""


class DeadlineExceededError(RayError, TimeoutError):
    """The request's end-to-end deadline expired before the work
    completed.  The LLM engine raises it at admission when the remaining
    budget cannot cover prefill + one decode step, and hands it to the
    consumer of a sequence its sweep expired (see _private/deadlines.py)."""

    def __init__(self, message: str = "deadline exceeded",
                 where: str = ""):
        self.where = where  # queued | running | get | admission
        super().__init__(message)

    def __reduce__(self):
        return (type(self), (str(self.args[0]) if self.args else
                             "deadline exceeded", self.where))

"""Error types (counterpart of reference ``omr_core/src/error.rs``)."""


class OmrError(Exception):
    """Base error for OMR operations."""


class InvertibleMatrixError(OmrError):
    """The digest weight matrix is singular mod p.

    Counterpart of ``OmrError::InvertibleMatrix``
    (reference ``omr_core/src/error.rs:4-8``).
    """


class IndexDecodeError(OmrError):
    """Not all pertinent indices could be recovered from the digest.

    Counterpart of the ``Err(())`` path at reference
    ``omr_core/src/retriever.rs:125-129``.
    """

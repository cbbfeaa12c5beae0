"""Framework exceptions (a copy of the JAX package's ``utils/exceptions.py``)."""


class CapreolusTPUError(Exception):
    pass


class MissingDocError(CapreolusTPUError):
    def __init__(self, qid, docid):
        super().__init__(f"missing doc with qid={qid} docid={docid}")
        self.qid = qid
        self.docid = docid


class OfflineEnvironmentError(CapreolusTPUError):
    """Raised when an artifact must be downloaded; the port never downloads."""

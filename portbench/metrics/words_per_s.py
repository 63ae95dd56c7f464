"""Every word the window handed ``DistributedWordEmbedding.train()``,
counted by the benchmark (the calls times the words of a call: the
corpus's words times its passes a call; the comparison checks the app's
block log against it), over the window's wall time (host clock; the
window ends with ``torch.cuda.synchronize()``)."""

UNIT = "words/s"


def read(run):
    we = run.get("we")
    return None if we is None else we["words"] / run["window_s"]

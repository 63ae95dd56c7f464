"""LogisticRegression application (the port of
``multiverso_tpu/models/logreg/``): config-file driven binary/multiclass
logistic regression on dense or sparse libsvm data, local or
parameter-server training (ArrayTable dense, MatrixTable sparse, two
KVTables for FTRL), on the host plane or the device plane, with
sigmoid/softmax/FTRL objectives and L1/L2 regularization.
"""

from multiverso_tpu_torch.models.logreg.configure import Configure  # noqa: F401
from multiverso_tpu_torch.models.logreg.logreg import LogReg  # noqa: F401

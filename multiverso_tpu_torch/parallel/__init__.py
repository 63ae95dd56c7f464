"""Device context and partition math; the multi-process world
(``multihost``) and its window codec (``flat``, ``wire``, ``seal``)."""

"""Host-side tools of the port: ``labels`` (CamVid colour <-> class index)
and ``video`` (the ctypes binding of the native video runtime under
``native/``). Copies of the JAX package's ``tools/labels.py`` and
``tools/video.py``; neither imports torch."""

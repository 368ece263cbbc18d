"""Host-side tools of the port, copies of the JAX package's ``tools/*``:
``labels`` (CamVid colour <-> class index), ``video`` (the ctypes binding
of the native video runtime under ``native/``), ``preprocess`` and
``camvid_decode`` (the compressed-dataset generators over that runtime),
``mv_fidelity`` (merged-MV accuracy against ground truth) and
``synth_scenes`` (labelled synthetic scenes in the CamVid layout, with
ground-truth merged MVs). None computes with torch."""

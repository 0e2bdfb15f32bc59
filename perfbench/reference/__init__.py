"""The benchmark's plain reference: the model (``model.py``), its training
steps (``train.py``) and the lower-precision products of the control
(``lowp.py``).  Plain PyTorch in float32; nothing of the program."""

"""Plain PyTorch references, one module per model family (found by the
configuration file's ``family``), and the training steps they share. They
import nothing of the program under test."""

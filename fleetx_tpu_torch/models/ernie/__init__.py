"""The ERNIE family: the MLM + NSP encoder and its pretraining module."""

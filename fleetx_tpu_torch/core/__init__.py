"""Task modules and the training engine of the port."""

"""The plain reference of ConvNet2 (cnn.py): plain PyTorch that imports
nothing of the program, run in float64 to judge the program's CU-depth
labels."""

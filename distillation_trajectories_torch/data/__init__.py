"""Data layer: MNIST / CIFAR-10 readers, the synthetic stand-in, the
shuffled batch loader."""
from .datasets import DataLoader, get_data_loader, get_real_images, load_dataset

from repro_torch.data.loader import batch_iterator, train_test_split
from repro_torch.data.synthetic import (cifar10_like, jsc_like,
                                        make_dataset, mnist_like)

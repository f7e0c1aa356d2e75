"""Models of the PyTorch/CUDA port."""
from .bert import (Bert, BertConfig, BertForMaskedLM,
                   BertForSequenceClassification, bert_base, bert_large,
                   ernie_base)
from .gpt import (GPT, GPTConfig, generate_greedy, gpt_1p3b, gpt_medium,
                  gpt_small, gpt_tiny)
from .resnet import (BasicBlock, BottleneckBlock, ResNet, resnet18,
                     resnet34, resnet50, resnet101, resnet152,
                     resnext50_32x4d, resnext50_64x4d, resnext101_32x4d,
                     resnext101_64x4d, resnext152_32x4d, wide_resnet50_2,
                     wide_resnet101_2)
from .vision import (VGG, AlexNet, LeNet, MobileNetV1, MobileNetV2,
                     mobilenet_v1, mobilenet_v2, vgg11, vgg13, vgg16, vgg19)
from .vision_extra import (DenseNet, GoogLeNet, InceptionV3, MobileNetV3Large,
                           MobileNetV3Small, ShuffleNetV2, SqueezeNet,
                           densenet121, densenet161, densenet169,
                           densenet201, googlenet, inception_v3,
                           mobilenet_v3_large, mobilenet_v3_small,
                           shufflenet_v2_x0_5, shufflenet_v2_x0_25,
                           shufflenet_v2_x1_0, shufflenet_v2_x1_5,
                           shufflenet_v2_x2_0, squeezenet1_0, squeezenet1_1)
from .weights import (from_jax_params, from_jax_train_state,
                      load_jax_int8_params, load_jax_params, load_jax_state,
                      train_state_numpy)

__all__ = ["GPT", "GPTConfig", "gpt_tiny", "gpt_small", "gpt_medium",
           "gpt_1p3b", "generate_greedy", "ResNet", "BasicBlock",
           "BottleneckBlock", "resnet18", "resnet34", "resnet50",
           "resnet101", "resnet152", "wide_resnet50_2", "wide_resnet101_2",
           "resnext50_32x4d", "resnext50_64x4d", "resnext101_32x4d",
           "resnext101_64x4d", "resnext152_32x4d", "from_jax_params",
           "from_jax_train_state", "load_jax_params", "load_jax_int8_params",
           "load_jax_state", "train_state_numpy", "Bert", "BertConfig",
           "BertForSequenceClassification", "BertForMaskedLM", "ernie_base",
           "bert_base", "bert_large", "LeNet", "AlexNet", "VGG", "vgg11",
           "vgg13", "vgg16", "vgg19", "MobileNetV1", "MobileNetV2",
           "mobilenet_v1", "mobilenet_v2", "MobileNetV3Small",
           "MobileNetV3Large", "mobilenet_v3_small", "mobilenet_v3_large",
           "DenseNet", "densenet121", "densenet161", "densenet169",
           "densenet201", "InceptionV3", "inception_v3", "ShuffleNetV2",
           "shufflenet_v2_x0_25", "shufflenet_v2_x0_5", "shufflenet_v2_x1_0",
           "shufflenet_v2_x1_5", "shufflenet_v2_x2_0", "SqueezeNet",
           "squeezenet1_0", "squeezenet1_1", "GoogLeNet", "googlenet"]

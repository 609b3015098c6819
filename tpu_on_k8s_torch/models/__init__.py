"""The models: the Llama- and GPT-2-family decoder with its KV-cache serving
mode, sampling and generate; BERT (``bert.py``); ResNet and the MNIST CNN
(``vision.py``)."""

"""Single-image inference and subset analysis, stdout-identical to the JAX
package's ``situation_recognition_tpu/inference.py`` (the reference's
``results`` / ``analize_subset``, ``sr.py:235-381``).

Reproduced quirks (deliberately, for output parity):

* ``imsitu_space.json`` is loaded from the hardcoded ``imSitu/`` folder of
  the working directory, ignoring ``--dataset_folder`` (sr.py:238).
* Role-noun "probabilities" are ``softmax(logits, dim=0)`` — normalized
  over the 6 roles, not the 2001 labels (sr.py:264, :324).
* The subset is sampled **with replacement** via ``randrange``
  (sr.py:294-295).
* ``''``/``'UNK'`` labels print as ``'-'`` (sr.py:275-279).
* ``IPython.display.display`` shows the image where IPython is installed,
  ``print`` of its repr otherwise.

As in the JAX package, the image is re-opened for display from the
dataset's ``img_dir`` (the reference hardcodes ``'resized_256/'``,
sr.py:367), or taken from the dataset's pixels when the file is not there
(a packed store).

``trainer`` is ``train.Trainer`` (its ``infer_verb`` / ``infer_nouns``
run on its device); anything with those two methods returning arrays or
tensors will do.
"""

from __future__ import annotations

import json
from os.path import isfile as pisfile, join as pjoin
from random import randrange
from typing import Dict, List, Tuple

import numpy as np
import torch

from situation_recognition_tpu_torch.data.transforms import (
    host_window, host_window_exact)


def _host(x) -> np.ndarray:
    """Logits (a tensor on any device, or an array) as f32 numpy."""
    if torch.is_tensor(x):
        return x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x, np.float32)


def _softmax(x: np.ndarray, axis: int) -> np.ndarray:
    x = x - x.max(axis=axis, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=axis, keepdims=True)


def _space() -> Tuple[dict, dict]:
    with open(pjoin("imSitu", "imsitu_space.json"), "r") as f:
        imsitu_space = json.load(f)
    return imsitu_space["nouns"], imsitu_space["verbs"]


def _display():
    try:
        from IPython.display import display
    except ImportError:
        display = print
    return display


def _role_label_dict(encoder, nouns_space, verbs_space, verb_name,
                     noun_ids) -> Dict[str, str]:
    roles = list(verbs_space[verb_name]["roles"].keys())
    labels: Dict[str, str] = {}
    for count, i in enumerate(noun_ids[: len(roles)]):
        name = encoder.label_list[int(i)]
        if name == "" or name == "UNK":
            labels[roles[count]] = "-"
        else:
            labels[roles[count]] = nouns_space[name]["gloss"][0]
    return labels


def _predict(trainer, window: np.ndarray, verb_id=None):
    """(verb id, its probability in %, noun logits (R, L)) of one window;
    the verb is predicted unless ``verb_id`` is given (then 100%)."""
    verb_prob = 100.0
    if verb_id is None:
        logits = _host(trainer.infer_verb(window))[0]
        verb_id = int(np.argmax(logits))
        verb_prob = float(np.max(_softmax(logits[None], axis=1))) * 100
    nlogits = _host(trainer.infer_nouns(
        window, np.array([verb_id], np.int32)))[0]
    return verb_id, verb_prob, nlogits


def results(trainer, image: str, encoder, gt_verb: str,
            preproc: str = "window",
            ) -> Tuple[str, float, Dict[str, str], List[float]]:
    """Reference ``results`` (sr.py:235-281).  ``preproc='exact'`` takes
    the reference-exact host Resize(224)+CenterCrop(224) window, which the
    device transform passes through unresized at ``image_size`` 224."""
    from PIL import Image

    nouns_space, verbs_space = _space()
    img = np.asarray(Image.open(image).convert("RGB"))
    if preproc == "exact":
        window = host_window_exact(img)[None]     # batch of 1
    else:
        window = host_window(img, train=False)[None]

    verb_id = None
    if gt_verb and encoder.verb_list.count(gt_verb):
        verb_id = encoder.verb_list.index(gt_verb)
    else:
        print("No ground truth verb found, calculating by myself...")
    verb_id, verb_prob, logits = _predict(trainer, window, verb_id)
    noun_ids = np.argmax(logits, axis=1)

    probabilities = _softmax(logits, axis=0).max(axis=1)
    labels_prob = [float(p) * 100 for p in probabilities]

    verb_name = encoder.verb_list[verb_id]
    labels = _role_label_dict(encoder, nouns_space, verbs_space,
                              verb_name, noun_ids)
    return verb_name, verb_prob, labels, labels_prob


def analize_subset(trainer, dev_set, encoder, size: int) -> None:
    """Reference ``analize_subset`` (sr.py:284-381)."""
    from PIL import Image

    display = _display()
    nouns_space, verbs_space = _space()
    indices = [randrange(0, len(dev_set)) for _ in range(0, size)]

    for idx in indices:
        img_name = dev_set.names[idx]
        window = dev_set.load_window(idx, None)[None]
        gt_verb = int(dev_set.verbs[idx])
        gt_noun = dev_set.labels[idx]           # (3, R)

        verb_id, verb_prob, nlogits = _predict(trainer, window)
        probabilities = _softmax(nlogits, axis=0).max(axis=1)
        labels_prob = [float(p) * 100 for p in probabilities]
        labels_tensor = np.argmax(nlogits, axis=1)

        verb_name = encoder.verb_list[verb_id]
        gt_verb_name = encoder.verb_list[gt_verb]

        labels = _role_label_dict(encoder, nouns_space, verbs_space,
                                  verb_name, labels_tensor)

        # gt labels: {role: (ann1, ann2, ann3)}; pad id -> '-'
        t_gt_noun = gt_noun.T                    # (R, 3)
        gt_roles = list(verbs_space[gt_verb_name]["roles"].keys())
        gt_labels = {}
        num_labels = encoder.get_num_labels()
        for count, i in enumerate(t_gt_noun[: len(gt_roles)]):
            t = ()
            for r in range(0, 3):
                idx_l = int(i[r]) if int(i[r]) != num_labels else -1
                if (idx_l == -1 or encoder.label_list[idx_l] == ""
                        or encoder.label_list[idx_l] == "UNK"):
                    t += ("-",)
                else:
                    t += (nouns_space[encoder.label_list[idx_l]]["gloss"][0],)
            gt_labels[gt_roles[count]] = (t[0], t[1], t[2])

        print("&" * 35)
        print("Analizing: ", img_name)
        path = pjoin(dev_set.img_dir, img_name)
        if pisfile(path):
            pil_im = Image.open(path, "r")
        else:
            # a packed store without the originals on disk: the pixels
            # come from the dataset
            pil_im = Image.fromarray(dev_set.load_image(idx))
        display(pil_im)

        print("action ({:.2f}%): {}".format(verb_prob, verb_name))

        c = 0
        for k, v in labels.items():
            print("{} ({:.2f}%): {}".format(k, labels_prob[c], v))
            c += 1

        print("---- Ground truth ----")
        print("action: {}".format(gt_verb_name))
        for k, v in gt_labels.items():
            print("{} = [{}, {}, {}]".format(k, v[0], v[1], v[2]))


def print_results(image: str, verb: str, verb_prob: float,
                  labels: Dict[str, str], labels_prob: List[float]) -> None:
    """The CLI's ``--test_img`` transcript of ``results`` (JAX
    ``cli.py:741-762``)."""
    from PIL import Image

    print('&' * 50)
    print('Analizing: ', image)
    _display()(Image.open(image, 'r'))
    print('&' * 50)
    print('action ({:.2f}%): {}'.format(verb_prob, verb))
    for c, (k, v) in enumerate(labels.items()):
        print('{} ({:.2f}%): {}'.format(k, labels_prob[c], v))

"""The port's spec builders against the JAX package's API types, on the CPU.

``serving_deployment``'s dict equals ``to_dict`` of the JAX function's
Deployment except for the command and the GPU request; every builder's
dict decodes into the API types and encodes back unchanged (it is the
wire form); the GPU manifests ask in the pod-level form and call
functions that exist.
"""

import copy
import importlib
import os
import shlex
import sys

import pytest
import yaml

from kubernetes1_tpu.api import types as t
from kubernetes1_tpu.machinery.scheme import from_dict, to_dict
from kubernetes1_tpu.workloads import llama as jllama
from kubernetes1_tpu_torch import GPU_RESOURCE
from kubernetes1_tpu_torch.workloads import llama, specs

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")
PORT_COMMAND = ["python", "-m", "kubernetes1_tpu_torch.workloads.llama", "--serve"]


@pytest.mark.parametrize("kw", [{}, {"replicas": 3, "scrape_port": 9100,
                                     "scrape_host": "127.0.0.1", "cpu": "2"},
                                {"name": "svc", "ns": "serving", "scrape_port": 8080}])
def test_serving_deployment_is_jax_but_for_the_command_and_the_card(kw):
    got = llama.serving_deployment(**kw)
    want = to_dict(jllama.serving_deployment(**kw))
    pod = want["spec"]["template"]["spec"]
    assert pod["containers"][0]["command"] == [
        "python", "-m", "kubernetes1_tpu.workloads.llama", "--serve"]
    pod["containers"][0]["command"] = PORT_COMMAND
    pod["extendedResources"] = [{"name": "gpu", "resource": GPU_RESOURCE, "quantity": 1}]
    pod["containers"][0]["extendedResourceRequests"] = ["gpu"]
    assert got == want
    # the wire form: it decodes into a Deployment and encodes back unchanged
    dep = from_dict(t.Deployment, copy.deepcopy(got))
    assert to_dict(dep) == got
    assert dep.spec.template.spec.extended_resources[0].resource == GPU_RESOURCE


def test_serving_command_is_the_ports_serve_main():
    mod = importlib.import_module(PORT_COMMAND[2])
    assert callable(mod._serve_main) and mod is llama


def test_payload_job_is_the_wire_form_with_the_card_in_the_pod(monkeypatch):
    monkeypatch.setenv("PYTHONPATH", "/site/extra")
    job = specs.payload_job("rn50", ["kubernetes1_tpu_torch.workloads.resnet_bench",
                                     "--steps", "2"], out="/tmp/r.json")
    assert to_dict(from_dict(t.Job, copy.deepcopy(job))) == job
    spec = job["spec"]
    assert (spec["parallelism"], spec["completions"], spec["backoffLimit"]) == (1, 1, 0)
    pod = spec["template"]["spec"]
    assert pod["restartPolicy"] == "Never"
    c = pod["containers"][0]
    assert c["command"] == [sys.executable, "-m", "kubernetes1_tpu_torch.workloads.resnet_bench",
                            "--steps", "2", "--out", "/tmp/r.json"]
    assert c["env"] == [{"name": "PYTHONPATH",
                         "value": f"{specs.REPO_ROOT}{os.pathsep}/site/extra"}]
    assert "resources" not in c  # no container limit: admission refuses nvidia.com/gpu there
    assert pod["extendedResources"] == [{"name": "gpu", "resource": GPU_RESOURCE,
                                         "quantity": 1}]
    assert c["extendedResourceRequests"] == ["gpu"]
    cpu_only = specs.payload_job("cpu", ["x"], gpus=0)
    assert "extendedResources" not in cpu_only["spec"]["template"]["spec"]


def test_gpu_request_with_affinity_decodes_to_a_resource_affinity():
    pod_spec = {"containers": [{"name": "a"}, {"name": "b"}]}
    specs.gpu_request(pod_spec, 2, name="cards", affinity=[
        {"key": "nvidia.com/gpu/model", "operator": "In", "values": ["NVIDIA H100 80GB HBM3"]},
        {"key": "nvidia.com/gpu/memory", "operator": "Gt", "values": ["80000"]}])
    spec = from_dict(t.PodSpec, copy.deepcopy(pod_spec))
    per = spec.extended_resources[0]
    assert (per.name, per.resource, per.quantity) == ("cards", GPU_RESOURCE, 2)
    assert [(r.key, r.operator, r.values) for r in per.affinity.required] == [
        ("nvidia.com/gpu/model", "In", ["NVIDIA H100 80GB HBM3"]),
        ("nvidia.com/gpu/memory", "Gt", ["80000"])]
    assert [c.extended_resource_requests for c in spec.containers] == [["cards"], ["cards"]]
    assert from_dict(t.PodSpec, to_dict(spec)) == spec  # ("In", the default, is left out)


@pytest.mark.parametrize("name,module,function", [
    ("gpu-mnist-single-card.yaml", "kubernetes1_tpu_torch.workloads.mnist", "train"),
    ("gpu-resnet50-h100.yaml", "kubernetes1_tpu_torch.workloads.resnet_bench", "main")])
def test_gpu_manifests_ask_in_the_pod_level_form_and_call_what_exists(name, module, function):
    with open(os.path.join(EXAMPLES, name)) as f:
        doc = yaml.safe_load(f)
    assert doc["kind"] == "Job"
    job = from_dict(t.Job, {k: v for k, v in doc.items() if k not in ("kind", "apiVersion")})
    pod = job.spec.template.spec
    assert [(p.resource, p.quantity) for p in pod.extended_resources] == [(GPU_RESOURCE, 1)]
    c = pod.containers[0]
    assert c.extended_resource_requests == [pod.extended_resources[0].name]
    assert GPU_RESOURCE not in (c.resources.limits or {})
    command = " ".join(shlex.quote(a) for a in c.command)
    assert module in command and hasattr(importlib.import_module(module), function)
    if function == "train":  # `python -c "... import train; ... train()"`
        assert f"import {function}" in c.command[-1] and f"{function}()" in c.command[-1]

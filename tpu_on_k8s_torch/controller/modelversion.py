"""ModelVersion controller: trained artifact → OCI image pipeline (the
counterpart of ``tpu_on_k8s/controller/modelversion.py``).

Analog of controllers/model/modelversion_controller.go
(SURVEY §2.6). On a ModelVersion appearing (emitted by the job engine on
success — engine.py ``_ensure_model_version``):

1. ensure the owning ``Model`` exists and owns the version
   (modelversion_controller.go:114-163);
2. create the storage PV + PVC via the provider registry and bind them (the
   in-memory stand-in for the volume binder; reference waits on ClaimBound,
   :180-184);
3. create the ``dockerfile`` ConfigMap — the build recipe that COPYs the
   artifact directory into the image (:286-311);
4. launch the image-build pod (Kaniko in the reference, :318-406) mounting
   dockerfile + artifact volume + registry secret;
5. poll its phase → ``ImageBuildSucceeded``/``Failed`` (:252-267) and update
   ``Model.status.latest_version`` (:234-242).

Storage: GCS (``tpu_on_k8s_torch.storage.GCSProvider``) beside the
reference operator's NFS/local pair; checkpoints written by
``tpu_on_k8s_torch.train`` land on the same volume the build pod packages.
"""
from __future__ import annotations

from typing import Optional

from tpu_on_k8s_torch.api import constants
from tpu_on_k8s_torch.api.core import (
    ConfigMap,
    Container,
    ObjectMeta,
    OwnerReference,
    Pod,
    PodPhase,
    PodSpec,
    Volume,
    VolumeMount,
    utcnow,
)
from tpu_on_k8s_torch.api.model_types import (
    ImageBuildPhase,
    Model,
    ModelVersion,
)
from tpu_on_k8s_torch.client.cluster import (
    AlreadyExistsError,
    InMemoryCluster,
    NotFoundError,
    WatchEvent,
)
from tpu_on_k8s_torch.controller.config import JobControllerConfig
from tpu_on_k8s_torch.controller.runtime import Controller, Manager, Request, Result
from tpu_on_k8s_torch.storage import (
    PersistentVolume,
    PersistentVolumeClaim,
    PersistentVolumeClaimSpec,
    provider_for_storage,
)

LABEL_MODEL_VERSION = "model.distributed.torch.io/model-version-name"
BUILDER_POD_SUFFIX = "-image-build"
DOCKERFILE = """FROM busybox:1.36
COPY build/ {model_path}
"""


class ModelVersionReconciler:
    def __init__(self, cluster: InMemoryCluster,
                 config: Optional[JobControllerConfig] = None) -> None:
        self.cluster = cluster
        self.config = config or JobControllerConfig()

    # ---------------------------------------------------------------- reconcile
    def reconcile(self, request: Request) -> Result:
        mv = self.cluster.try_get(ModelVersion, request.namespace, request.name)
        if mv is None:
            return Result()
        if mv.status.image_build_phase in (ImageBuildPhase.SUCCEEDED,
                                           ImageBuildPhase.FAILED):
            return Result()

        model = self._ensure_model(mv)
        provider = provider_for_storage(mv.spec.storage)
        if provider is None:
            return self._finish(mv, model, ImageBuildPhase.FAILED,
                                "no storage provider configured for model version")

        if not self._ensure_storage(mv, provider):
            return Result(requeue_after=1.0)  # claim not bound yet (:180-184)
        self._ensure_dockerfile(mv, provider)
        pod = self._ensure_build_pod(mv, provider)

        if pod.status.phase == PodPhase.SUCCEEDED:
            return self._finish(mv, model, ImageBuildPhase.SUCCEEDED, "image built")
        if pod.status.phase == PodPhase.FAILED:
            return self._finish(mv, model, ImageBuildPhase.FAILED,
                                pod.status.message or "image build pod failed")
        self._set_phase(mv, ImageBuildPhase.BUILDING, "image build in progress")
        return Result(requeue_after=self.config.sync_period_seconds)

    # ------------------------------------------------------------------- steps
    def _ensure_model(self, mv: ModelVersion) -> Model:
        """Ensure the named Model exists and owns this version
        (modelversion_controller.go:114-163)."""
        name = mv.spec.model_name or mv.metadata.name
        model = self.cluster.try_get(Model, mv.metadata.namespace, name)
        if model is None:
            model = Model(metadata=ObjectMeta(
                name=name, namespace=mv.metadata.namespace,
                labels={constants.LABEL_MODEL_NAME: name}))
            try:
                model = self.cluster.create(model)
            except AlreadyExistsError:
                model = self.cluster.get(Model, mv.metadata.namespace, name)
        if not any(r.uid == model.metadata.uid
                   for r in mv.metadata.owner_references):
            def mutate(v: ModelVersion) -> None:
                if not any(r.uid == model.metadata.uid
                           for r in v.metadata.owner_references):
                    v.metadata.owner_references.append(OwnerReference(
                        api_version=model.api_version, kind=model.kind,
                        name=model.metadata.name, uid=model.metadata.uid))
            try:
                self.cluster.update_with_retry(
                    ModelVersion, mv.metadata.namespace, mv.metadata.name, mutate)
            except NotFoundError:
                pass
        return model

    def _pv_name(self, mv: ModelVersion) -> str:
        """Local storage pins one PV per node (reference per-node names,
        :412-518); other flavors share one."""
        ls = mv.spec.storage.local_storage
        if ls is not None and ls.node_name:
            return f"mv-pv-{mv.metadata.name}-{ls.node_name}"
        return f"mv-pv-{mv.metadata.name}"

    def _ensure_storage(self, mv: ModelVersion, provider) -> bool:
        """PV + PVC + bind. Returns True once the claim is Bound. The bind
        step stands in for kube-controller-manager's volume binder."""
        pv_name = self._pv_name(mv)
        pv = self.cluster.try_get(PersistentVolume, "", pv_name)
        if pv is None:
            pv = provider.create_persistent_volume(mv, pv_name)
            pv.metadata.namespace = ""
            try:
                self.cluster.create(pv)
            except AlreadyExistsError:
                pass
        pvc = self.cluster.try_get(PersistentVolumeClaim, mv.metadata.namespace, pv_name)
        if pvc is None:
            pvc = PersistentVolumeClaim(
                metadata=ObjectMeta(
                    name=pv_name, namespace=mv.metadata.namespace,
                    labels={LABEL_MODEL_VERSION: mv.metadata.name},
                    owner_references=[self._owner_ref(mv)]),
                spec=PersistentVolumeClaimSpec(volume_name=pv_name))
            try:
                pvc = self.cluster.create(pvc)
            except AlreadyExistsError:
                pvc = self.cluster.get(PersistentVolumeClaim, mv.metadata.namespace, pv_name)
        if pvc.status.phase != "Bound":
            def mutate(c: PersistentVolumeClaim) -> None:
                c.status.phase = "Bound"
            try:
                self.cluster.update_with_retry(
                    PersistentVolumeClaim, mv.metadata.namespace, pv_name,
                    mutate, subresource="status")
            except NotFoundError:
                return False
        return True

    @staticmethod
    def _dockerfile_name(mv: ModelVersion) -> str:
        return f"{mv.metadata.name}-dockerfile"

    def _ensure_dockerfile(self, mv: ModelVersion, provider) -> None:
        name = self._dockerfile_name(mv)
        if self.cluster.try_get(ConfigMap, mv.metadata.namespace, name) is not None:
            return
        cm = ConfigMap(
            metadata=ObjectMeta(
                name=name, namespace=mv.metadata.namespace,
                labels={LABEL_MODEL_VERSION: mv.metadata.name},
                owner_references=[self._owner_ref(mv)]),
            data={"dockerfile": DOCKERFILE.format(
                model_path=provider.get_model_mount_path(mv))})
        try:
            self.cluster.create(cm)
        except AlreadyExistsError:
            pass

    def _ensure_build_pod(self, mv: ModelVersion, provider) -> Pod:
        """The Kaniko-pod analog (:318-406): builder image + dockerfile +
        artifact volume + registry secret, node-pinned for local storage."""
        name = f"{mv.metadata.name}{BUILDER_POD_SUFFIX}"
        pod = self.cluster.try_get(Pod, mv.metadata.namespace, name)
        if pod is not None:
            return pod
        image = self._image_ref(mv)
        spec = PodSpec(
            restart_policy="Never",
            containers=[Container(
                name="image-builder",
                image=self.config.model_image_builder,
                args=[f"--dockerfile=/workspace/dockerfile",
                      f"--context=dir:///workspace",
                      f"--destination={image}"],
                volume_mounts=[
                    # ConfigMap materializes one file per key under the mount:
                    # key "dockerfile" → /workspace/dockerfile (:391-394).
                    VolumeMount(name="dockerfile", mount_path="/workspace"),
                    # The artifact PVC is the build context's COPY source
                    # (:363-390).
                    VolumeMount(name="artifact", mount_path="/workspace/build"),
                    VolumeMount(name="regcred",
                                mount_path="/kaniko/.docker", read_only=True),
                ])],
            volumes=[
                Volume(name="dockerfile",
                       config_map_name=self._dockerfile_name(mv)),
                # Kaniko reads /kaniko/.docker/config.json; the dockerconfig
                # secret key must be projected to that filename (:348-356).
                Volume(name="regcred", secret_name=constants.REGISTRY_SECRET_NAME,
                       items={".dockerconfigjson": "config.json"}),
                Volume(name="artifact", pvc_claim_name=self._pv_name(mv)),
            ])
        ls = mv.spec.storage.local_storage
        if ls is not None and ls.node_name:
            # Local artifacts only exist on the training node: pin the build
            # there (reference node-pinned Kaniko pod, :318-406).
            spec.node_name = ls.node_name
        pod = Pod(
            metadata=ObjectMeta(
                name=name, namespace=mv.metadata.namespace,
                labels={LABEL_MODEL_VERSION: mv.metadata.name},
                owner_references=[self._owner_ref(mv)]),
            spec=spec)
        try:
            return self.cluster.create(pod)
        except AlreadyExistsError:
            return self.cluster.get(Pod, mv.metadata.namespace, name)

    # ------------------------------------------------------------------ status
    def _image_ref(self, mv: ModelVersion) -> str:
        tag = mv.spec.image_tag or mv.metadata.name
        repo = mv.spec.image_repo or f"registry.local/{mv.spec.model_name or mv.metadata.name}"
        return f"{repo}:{tag}"

    def _set_phase(self, mv: ModelVersion, phase: ImageBuildPhase, message: str) -> None:
        if mv.status.image_build_phase == phase and mv.status.message == message:
            return

        def mutate(v: ModelVersion) -> None:
            v.status.image_build_phase = phase
            v.status.message = message
            if phase in (ImageBuildPhase.SUCCEEDED, ImageBuildPhase.FAILED):
                v.status.finish_time = v.status.finish_time or utcnow()
                if phase == ImageBuildPhase.SUCCEEDED:
                    v.status.image = self._image_ref(v)
        try:
            self.cluster.update_with_retry(
                ModelVersion, mv.metadata.namespace, mv.metadata.name, mutate,
                subresource="status")
        except NotFoundError:
            pass

    def _finish(self, mv: ModelVersion, model: Model,
                phase: ImageBuildPhase, message: str) -> Result:
        self._set_phase(mv, phase, message)
        if phase == ImageBuildPhase.SUCCEEDED:
            def mutate(m: Model) -> None:
                m.status.latest_version_name = mv.metadata.name
                m.status.latest_image = self._image_ref(mv)
            try:
                self.cluster.update_with_retry(
                    Model, model.metadata.namespace, model.metadata.name, mutate,
                    subresource="status")
            except NotFoundError:
                pass
        self.cluster.record_event(
            mv, "Normal" if phase == ImageBuildPhase.SUCCEEDED else "Warning",
            str(phase.value), message)
        return Result()

    def _owner_ref(self, mv: ModelVersion) -> OwnerReference:
        return OwnerReference(
            api_version=mv.api_version, kind=mv.kind, name=mv.metadata.name,
            uid=mv.metadata.uid, controller=True)


def setup_modelversion_controller(
    cluster: InMemoryCluster,
    manager: Manager,
    config: Optional[JobControllerConfig] = None,
) -> ModelVersionReconciler:
    """Wire the controller: watch ModelVersions + their build pods
    (reference SetupWithManager, modelversion_controller.go:45-67)."""
    reconciler = ModelVersionReconciler(cluster, config=config)
    controller = Controller("modelversion", reconciler.reconcile)
    manager.add_controller(controller)

    def on_event(event: WatchEvent) -> None:
        if event.kind == constants.KIND_MODELVERSION:
            controller.enqueue(event.obj.metadata.namespace, event.obj.metadata.name)
        elif event.kind == "Pod":
            owner = event.obj.metadata.labels.get(LABEL_MODEL_VERSION)
            if owner:
                controller.enqueue(event.obj.metadata.namespace, owner)

    cluster.watch(on_event)
    return reconciler
